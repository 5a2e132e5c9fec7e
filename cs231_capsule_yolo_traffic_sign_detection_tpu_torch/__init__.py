"""PyTorch/CUDA port of the capsule-YOLO traffic-sign framework.

    import cs231_capsule_yolo_traffic_sign_detection_tpu_torch as cyt_torch

The JAX package ``cs231_capsule_yolo_traffic_sign_detection_tpu`` beside
it is the reference; this package imports neither it nor ``jax``.  It
holds darknet_r serving (DarkNet-19 at 448 px with BN folded into the
convs, the fused input stage and pool+leaky as hand-written CUDA
kernels for sm_90a in ``csrc/``, the full-width grid decode, the
detection metrics) and training, darknet_d (the same network with two
boxes and no classes) and darkcapsule (a capsule head over grid cells),
the capsule classifier's serving and training (the routing and its
backward as CUDA kernels), the cnn classifier's, and the two-stage
detect-then-classify pipeline: all five models of the JAX package's
registry.  See README.md, "PyTorch port".
"""

from . import config  # noqa: F401
from .params import Params  # noqa: F401
