from .capsule_net import CapsuleNet  # noqa: F401
from .darknet import DARKNET_LAYERS, DarkNet  # noqa: F401
from .convnet import ConvNet  # noqa: F401
from .darkcapsule import DarkCapsuleNet  # noqa: F401
