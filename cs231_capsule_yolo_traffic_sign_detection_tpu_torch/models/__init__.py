from .darknet import DARKNET_LAYERS, DarkNet  # noqa: F401
