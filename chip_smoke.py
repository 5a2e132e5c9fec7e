#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Run from the repository root on a machine with a card and nvcc.  Phases
(any failure ends the run with a non-zero exit; nothing is caught; each
path of phases 5, 8, 11, 13, 15-17, 18-20, 21-23, 25-27 and 32 runs with
all four kernels' launch counts set to 0 just before it, and is checked
on all four just after):

1. require CUDA; print the card's name and power limit (nvidia-smi);
2. build the kernels (csrc/*.cu -> build/kernels/) and print the time;
3. K1 pool_leaky against its plain version at DarkNet's four pool shapes
   at batch 32 (f32 bit-exact, bf16 within 1e-2);
4. K2 input_stage against its plain version at [32, 448, 448, 3] and at
   two ragged shapes (scalar and 16-byte halo loads), each call just
   after every SM's shared memory was filled with NaN: f32 (the 3xTF32
   mma.sync kernel: split TF32 operands on the tensor cores) rtol/atol
   1e-5 against the plain version with TF32 off, and on 0-255 integer
   frames (exact in TF32) with BN-folded He weights (the serving
   slice's scale) rtol
   1e-5 / atol 1e-5 of the largest output against the plain version in
   f64; bf16 (the mma.sync kernel) within one bf16 ulp (rtol 2^-7, atol
   1e-5) of the one-rounding reference (f32 math on the bf16 operands,
   rounded once), within mean 5e-3 / max 0.1 of the plain bf16 path;
   both types bit-identical over two calls;
5. the darknet_r serving slice at full width (448 px, n_grid 14, B=1,
   C=43, seeded weights) through `dark_pred`, as the CLI calls it, over
   64 synthetic scenes in batches of 32, in f32 and bf16: K2 must launch
   once and K1 four times per batch, y_hat must match eval-mode DarkNet
   on the card, and the f32 box lists must equal the reference's;
6. timings with CUDA events: each kernel beside its bound for its data
   type, its plain version and the PyTorch yardstick composition (K2
   per data type, both on mma.sync: f32 as 3xTF32, its bound at TF32's
   rate beside the CUDA-core bound of earlier runs; bf16), and
   forward+decode img/s at batch 32 with a torch.profiler breakdown of
   the same calls (kernel time by group, device busy share);
7. K3 routing against its plain version at CapsuleNet's shape
   [64, 1296, 8] x [1296, 43, 8, 16] (f32 rtol 2e-5 / atol 2e-6, bf16
   rtol .05 / atol 5e-3), at a ragged shape and at a saturating input,
   each call just after every SM's shared memory was filled with NaN (a
   read of a slot the kernel never wrote then shows as a wrong result);
8. the capsule classifier's serving slice at full width (CapsuleNet,
   43 classes, seeded weights) through `class_pred`, as the CLI calls
   it, over 512 synthetic crops in batches of 64, f32 then bf16: K3 must
   launch once per batch, the scores must match an eval forward in the
   same dtype with the plain routing on the card (K3's bands), and the
   argmax classes must agree away from ties;
9. the launch plans K3 and K4 pick (node tiles, blocks, element groups,
   cluster size, clusters resident); timings: K3 per batch beside its
   bound, its plain version, its time at one iteration (the votes pass
   without logits), its time with the L2 flushed before every call
   (FLUSH_BYTES written between calls, outside the timed span), the
   count of CUDA kernels one call issues and the device time of each
   (torch.profiler); capsule serving img/s at batch 64 with the profile
   of the same calls;
10. K4 routing backward against its plain version at CapsuleNet's shape,
   at a ragged shape and at a saturating input, f32 and bf16 (f32 rtol
   1e-4 / atol 1e-6, bf16 rtol .08 / atol .02 of the gradient's largest
   value: the bands of tests/test_pallas_routing.py; the saturated case
   scales atol by the gradient's largest value; shared memory filled
   with NaN before each call, as in phase 7), and the autograd op
   (K3 + K4) against torch.autograd through the plain forward;
11. the capsule training slice at full width through
   `train_and_evaluate`, as the CLI calls it: batch 64, 512/128
   synthetic crops, 2 epochs, f32 then bf16.  K4 must launch once per
   train batch and K3 once per train and eval batch, the train loss must
   fall, and `class_pred` must read the written last.ckpt back (finite
   scores).  Then, on one batch: every parameter's gradient after a step
   is finite and non-zero, and one step's gradients match the same step
   with the plain routing (the bands of phase 10, atol scaled by each
   gradient's largest value);
12. timings: K4 per call beside its bound and its plain version, warm
   and with the L2 flushed, and the device time of each CUDA kernel one
   call issues; the train step's ms per batch of 64 and img/s, f32 and
   bf16, with the profile of the same calls;
13. the darknet_r training slice at full width through
   `train_and_evaluate`, as the CLI calls it: 448 px, batch 32, dropout
   0.5, 64/16 synthetic scenes, 2 epochs, f32 then bf16.  No kernel may
   launch during training (the step runs through cuDNN, BN, pool, Adam),
   the train loss must fall, and `dark_pred` must read the written
   last.ckpt back with K2 once and K1 four times per batch and match
   eval-mode DarkNet from the same checkpoint (phase 5's checks and
   bands).  On one batch: after a step every parameter's gradient is
   finite and non-zero.  Two 1-epoch runs from one seed give the same
   loss to the bit, another seed another (dropout masks from the
   trainer's generator; cuDNN's deterministic algorithms for this
   pair).  Then 1 epoch fine-tuning from a darknet19 npz the script
   writes, fine_tune 18: the frozen blocks stay the npz's to the bit,
   the head moves, and bn_1's running mean moves;
14. timings: the darknet_r train step (forward with dropout, dark_loss,
   backward, Adam) at batch 32, f32 and bf16, ms and img/s beside its
   operation bound, with the profile of the same calls (conv forward,
   dgrad, wgrad, BN, pool, leaky, dropout, Adam, other);
15. the cnn classifier's training at full width through
   `train_and_evaluate` (experiments/cnn/params.json: 32 px, 43 classes,
   batch 64, dropout 0.5), 512/128 synthetic crops, 2 epochs, f32 then
   bf16: no kernel may launch, the train loss must fall, after one step
   every gradient is finite and non-zero (but the two conv biases in
   front of a train-mode BN, whose gradient is rounding noise), and
   `class_pred` reads the written last.ckpt back; the step's ms and
   img/s;
16. the two-stage pipeline through `dark_class_pred` (the host
   composition), as the CLI's --combine calls it: phase 5's darknet_r
   over its 64 scenes, then phase 8's CapsuleNet and phase 15's
   trained ConvNet on the crops, f32 and bf16: K2 once and K1 four
   times per detector batch, K3 once per 64 crops (capsule) or never
   (cnn), K4 never; crops found; the combined grid's detector channels
   equal `dark_pred`'s y_hat and its class channels `class_pred` on the
   same crops; frames/s end to end and the time by stage (detector,
   crops, classifier, combine);
17. K3 at the fused path's batch, 32 frames x 16 crops = 512, against
   its plain version after a NaN fill of shared memory, and its time;
   then the fused pipeline (`dark_class_pred(device_crop=True)`,
   max_crops 16), f32 and bf16: K3 once per detector batch (capsule),
   frames/s, and class scores within K3's bands of the same composition
   with the plain routing;
18. darknet_d serving (experiments/darknet_d/params.json: 448 px, B=2,
   C=0, batch 32) through `dark_pred` over 64 synthetic scenes, a
   seeded DarkNet(2, 0) with BN statistics set as phase 5's, f32 and
   bf16: K2 once and K1 four times per batch, y_hat against eval-mode
   DarkNet in phase 5's bands, the f32 boxes equal; serving img/s with
   the profile (kernel time by group, device busy);
19. darknet_d training through `train_and_evaluate` (64/16 scenes, 2
   epochs, f32 then bf16; --mode overfit's 3/3; one fine-tune epoch from
   an npz, blocks 1-18 frozen): no kernel launch, the loss falls, the
   "train/test avg iou" lines, finite non-zero gradients, each trained
   last.ckpt served as in phase 18; the step's ms beside its operation
   bound, with the profile; `dark_class_pred` on phase 18's detector
   with phase 15's ConvNet (host path) and phase 8's CapsuleNet (host
   and fused): K2 x1, K1 x4 per detector batch, K3 per 64 crops (host)
   or per detector batch (fused), and the JAX package's nan / 0.0
   combine metrics;
20. darkcapsule (experiments/darkcapsule/params.json: n_grid 7, 224 px,
   batch 32) through `train_and_evaluate` (64/16 scenes, 2 epochs, f32
   then bf16): no kernel launch (its one-capsule routing is the closed
   form), the loss falls, the route weights and every conv weight with
   finite non-zero gradients; the step's ms beside its operation bound
   with the profile, the eval forward's img/s; the f32-trained model's
   forward on the card against the CPU's (atol 1e-4); the CLI's predict
   writes its empty metric file.

21. predict's outputs through the CLI from a GTSDB-style data dir
   (PPM_FRAMES of phase 5's scenes as P6 files with a header comment,
   test_names.npy, test.p), with phase 5's detector: the frames read
   back equal; `--nms` (K2 x1, K1 x4), its kept boxes equal a numpy
   greedy NMS on the same decode, each output/<i>.png (decoded here with
   zlib) equals the frame with the kept boxes and the ground truth drawn
   and holds a rectangle corner at each kept box, detect_ap/d_AP.png is
   1000 x 800; then `--combine cnn|capsule --device_crop` (K3 x1 with
   capsule), their mAP plots and annotated frames;
22. int8 serving (`--dtype int8`) through `dark_detect` over phase 5's
   64 scenes: no kernel launch (the int8 chain pools in int8 and runs
   conv1 as an int8 product); on one batch of phase 5's detector the
   chain equal bit for bit to itself with exact f64 products in place of
   im2col and `_int_mm`, and layer 1's s32 accumulators equal to the
   CPU's product of the same int8 operands; y_hat within JAX's int8
   bands of the f32 serving (mean < 0.01, max < 0.12) on a full-width
   detector built as JAX's int8 test builds its network; phase 5's
   detector's error against f32 by channel group and each layer's
   relative error, printed (a measurement: out of those bands, as in the
   JAX package); the forward+decode's ms and img/s at batch 32 beside
   phase 6's f32 and bf16, its profile (GEMMs, requant, epilogue, int8
   pools, im2col) and peak memory;
23. the two-stage paths under int8: fused with the int8 ConvNet (no
   launch), fused with CapsuleNet in f32 (K3 once a detector batch at
   B 512), the host path with the f32 ConvNet; frames/s;
24. a measurement: one darknet_r train step at 448 px, batch 32, on
   noise, f32 (cuDNN, TF32 off) against f64 on the card from the same
   weights; each conv weight gradient's largest error over its max|g|
   and its cosine;
25. serving artifacts (export.py) of phase 5's detector, f32, bf16 and
   int8, exported on the card with a symbolic batch, saved, loaded and
   called at batch 32 and 5: the graph's cyt::* nodes, K2 once and K1
   four times a call (none under int8), the confidences against
   `dark_detect`'s y_hat (phase 5's bands), equality with the live fn,
   the ms of a batch of artifact and live fn in turns;
26. the CapsuleNet artifact at batch 64, f32 and bf16 (K3 once a call;
   scores against `class_pred`, K3's bands), and the fused two-stage
   artifacts with phase 8's CapsuleNet and a ConvNet at max_crops 16, f32,
   bf16 and int8 (K2 x1, K1 x4 a batch but int8, K3 x1 with CapsuleNet;
   class scores against the live fused path, K3's bands); ms in turns;
27. --routing: CapsuleNet at batch 64, serving and one train step under
   pallas (K3 x1, K4 x1) and xla (no launch), f32 and bf16: scores and
   gradients in K3's and K4's bands of each other, both times; auto
   must resolve to the faster;
28. --remat: one darknet_r train step at 448 px, batch 32, dropout 0.5,
   f32 and bf16, with and without remat (cuDNN deterministic): the loss
   to the bit, the gradients' cosines at least 0.99999, BN buffers and
   the generator state equal; peak memory and step ms of each; the s2d
   int8 chain equal to the resident chain to the bit, both ms in turns;
29. --stream: darknet_r training (448 px, batch 32, dropout 0.5, 2
   epochs of 64 + 16 synthetic scenes) through `train_and_evaluate` over
   --npy files, resident (centered float32) and streamed (memmapped
   uint8 through the native prefetcher and pinned memory), cuDNN
   deterministic: no launch, the losses equal; then a timed epoch of
   each: ms a step beside phase 14's, the busy share (profile) and the
   host's wait on the prefetcher;
30. the mesh (parallel/): a one-rank NCCL group through the module API
   (make_mesh(n_data=1)), one CapsuleNet step (K3 x1, K4 x1) and one
   darknet_r step each equal to the bit to the plain Trainer's (cuDNN
   deterministic), ms with and without the mesh; then two spawned ranks
   on the one card over gloo (NCCL refuses two ranks of one
   communicator on a device): the capsule step at 32 of 64 rows a rank
   (K3 x1, K4 x1 on each; the route weights' gradient in K4's bands of
   the single step, the others by cosine) and darknet_r `dark_detect` of
   phase 5's scenes at batch 32, 16 rows a rank (K2 x1, K1 x4 a batch on
   each; y_hat within phase 5's f32 band of single-process serving);
31. --async_ckpt --ckpt_every 2 on 3 darknet_r epochs (cuDNN
   deterministic): the same files with the same tensors as the
   synchronous run; both walls a epoch.
32. --scan_epoch, each train and eval epoch as replays of captured CUDA
   graphs (one a distinct batch size), against the per-batch loop:
   capsule f32 through `train_and_evaluate`, on against off (last.ckpt,
   its optimizer in the reference format, and the losses equal to the
   bit; K3 and K4 counted); then each model at its params.json width in
   f32 and bf16 (capsule and cnn at batch 64 over 2000 crops, 16
   batches of 63 and 16 of 62, two graphs; darknet_r, darknet_d at 448
   px and darkcapsule at 224 px, batch 32 over 128 scenes): 2 train and
   eval epochs captured and looped, cuDNN deterministic, with every
   batch's loss, the outputs, parameters, BN buffers, Adam state and
   generator equal to the bit (or within the loop's own band where it
   differs from itself); then, cuDNN as it runs by default, the capture's
   seconds, SCAN_TURNS turns of a train and an eval epoch each way
   (median, spread, ms a step; the port's `profiling.StepTimer`), busy
   share (a train epoch under `profiling.trace`), an epoch's
   transient peak memory and the graphs' pool, and whether the captured
   epoch is no slower than the loop beyond the loop's spread (what
   `driver.SCAN_EPOCH_AUTO_ON_CARD` rests on).  In the capsule runs the
   profile of a captured train epoch counts one K3 and one K4 kernel a
   replayed batch, as the wrappers' counts do; bf16 capsule's eval
   replay after train replays equals an eager forward on the current
   route weights; darknet_r f32 with --remat (dropout 0.5, 7 replays)
   and capsule f32 on a one-rank NCCL mesh equal the loop to the bit.
Phases 29-32 print their walls.

The kernels line's K1 and K2 launches count phases 5, 18, 25 and 30
(f32), K3's phases 8, 26, 30 and 32 (its f32 captured capsule runs), K4's
phases 11, 27, 30 and 32.  The line
before the last is the JSON ``{"kernels": [...]}``; the last
line is ``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

import contextlib
import io
import json
import os
import pickle
import shutil
import struct
import subprocess
import time
import warnings
import zlib

import numpy as np
import torch
import torch.nn.functional as F

# the port sits beside this script; alone, the script stops here
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch import (
    Params, __main__ as cli, export, losses, predict, profiling, viz)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.data import (
    loader, stream as data_stream)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.device import (
    resolve_device)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.metrics import (
    classification as clsm, detection as det)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.models import (
    DARKNET_LAYERS, CapsuleNet, ConvNet, DarkCapsuleNet, DarkNet)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.models.darkcapsule \
    import DARKCAPSULE_LAYERS
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.models.registry \
    import resolve_routing_impl
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.ops import (
    _build, boxes as box_ops, capsule as caps, crop, decode,
    input_stage as ist, pool, quant, routing)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.ops.preprocess \
    import preprocess_images
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.parallel import (
    mesh as par)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.train import (
    checkpoint as ckpt, driver, steps)

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
# H100 SXM dense peaks: f32 outside the tensor cores; bf16 and TF32 (K2
# f32's three split products) on them
FLOP_PER_S = {torch.float32: 67e12, torch.bfloat16: 989e12, "tf32": 495e12}
BATCH = 32
FLUSH_BYTES = 128 << 20     # written between cold-L2 timed calls (L2 50 MB)
# bf16 slice against the f32 eval DarkNet: mean abs error per channel
# group, about twice what the seeded full-width run measures
BF16_BANDS = {"confidence": 2e-2, "box": 2e-2, "class": 2e-3}
POOL_SHAPES = [(BATCH, 224, 224, 64), (BATCH, 112, 112, 128),
               (BATCH, 56, 56, 256), (BATCH, 28, 28, 512)]
# K2's shapes in phase 4: darknet_r's, then two that fill no tile, with
# W2 % 4 != 0 (scalar halo loads in both types) and W2 % 8 == 0 (16-byte
# loads)
K2_SHAPES = [(BATCH, 448, 448, 3), (3, 66, 130, 3), (2, 66, 136, 3)]
# K2 bf16 against the one-rounding reference: one bf16 ulp
K2_BF16_TOL = dict(rtol=2 ** -7, atol=1e-5)
# the capsule slice: batch 64 (experiments/capsule/params.json), 8 batches
CAPS_BATCH, CAPS_CROPS = 64, 512
# K3's bands: those of tests/test_pallas_routing.py
K3_TOL = {False: dict(rtol=2e-5, atol=2e-6), True: dict(rtol=0.05, atol=5e-3)}
# K4's bands: f32 rtol/atol, bf16 rtol and atol as a share of the
# gradient's largest value (tests/test_pallas_routing.py:46-106)
K4_TOL = {False: dict(rtol=1e-4, atol=1e-6), True: dict(rtol=0.08, atol=0.02)}
# the training slice: 2 epochs over the JAX fallback's 512/128 crops
TRAIN_EPOCHS, TRAIN_CROPS, EVAL_CROPS = 2, 512, 128
# the detector's training slice: 2 epochs over the JAX fallback's 64/16
# scenes at 448 px (loader._SYNTH_FULL["detection"])
DARK_TRAIN_SCENES, DARK_EVAL_SCENES = 64, 16
# phase 32 (--scan_epoch): each model's train and eval scenes or crops
# (the classifiers' 2000 crops at batch 64: 16 batches of 63 and 16 of
# 62, two graphs), turns of the timing
SCAN_CASES = (("capsule", 2000, 250), ("cnn", 2000, 250),
              ("darknet_r", 128, 32), ("darknet_d", 128, 32),
              ("darkcapsule", 128, 32))
SCAN_TURNS = 3
# the fused two-stage path's static cap: boxes classified per frame
MAX_CROPS = 16
# phase 21: the GTSDB-style data dir holds this many of phase 5's scenes
PPM_FRAMES = 8
# JAX's bands of int8 serving against f32 (tests/test_quant.py:64-65)
INT8_BANDS = (0.01, 0.12)
# the int8 chain's profile groups: its GEMMs (and the f32 head's), the
# requantization, the epilogue, the int8 pools, im2col and casts
INT8_GROUPS = (("GEMM (_int_mm; f32 head)", ("gemm", "xmma", "cutlass",
                                             "imma", "cublas")),
               ("requant (div, round, clamp)", ("div", "round", "clamp")),
               ("epilogue (mul, add, leaky)", ("leaky", "mul", "add")),
               ("int8 pool (amax)", ("reduce_kernel", "max")),
               ("im2col, casts (copy, fill)", ("copy", "fill", "cat")))
# the card's name and power limit (nvidia-smi), printed beside each time
SMI = "card not read yet"
# kernel-name substrings for the profiles' groups, first match wins
GROUPS = (("routing_bwd (K4)", ("routing_bwd_sweep", "bwd_prep_kernel",
                                "bwd_finish_kernel")),
          ("routing", ("routing_kernel",)),
          ("Adam", ("adam", "multi_tensor_apply")),
          ("input_stage", ("input_stage_tf32x3_kernel",
                           "input_stage_mma_kernel")),
          ("pool_leaky", ("pool_leaky_kernel",)),
          ("leaky_relu", ("leaky_relu",)),
          ("bias add", ("functor_add",)),
          ("layout", ("nchwtonhwc", "nhwctonchw")),
          ("conv (cuDNN)", ("conv", "gemm", "xmma", "cudnn", "cutlass",
                            "sm90", "implicit", "fprop", "nhwc", "nchw")))
# the cnn train step: BN and pooling before the convs, as DARK_GROUPS
# (cuDNN's convs and cuBLAS's dense layers share kernel-name parts)
CNN_GROUPS = (("Adam", ("adam", "multi_tensor_apply")),
              ("dropout mask", ("bernoulli",)),
              ("BN", ("batch_norm", "batchnorm", "bn_fw", "bn_bw")),
              ("pool", ("max_pool", "maxpool", "pooling")),
              ("leaky", ("leaky",)),
              ("conv, dense (cuDNN, cuBLAS)", (
                  "conv", "gemm", "gemv", "xmma", "cudnn", "cublas",
                  "cutlass", "sm90", "implicit", "fprop", "dgrad", "wgrad",
                  "splitk", "winograd", "fft")))
# the detector's train step: cuDNN's BN and pooling kernels carry
# "cudnn"/"nhwc" in their names, so they come before the convs
DARK_GROUPS = (("Adam", ("adam", "multi_tensor_apply")),
               ("dropout mask", ("bernoulli",)),
               ("BN", ("batch_norm", "batchnorm", "bn_fw", "bn_bw")),
               ("pool", ("max_pool", "maxpool", "pooling")),
               ("leaky", ("leaky",)),
               ("conv wgrad", ("wgrad",)),
               ("conv dgrad", ("dgrad",)),
               ("layout", ("nchwtonhwc", "nhwctonchw")),
               ("where/div (dropout apply, loss)", ("where", "div")),
               ("conv fprop, other cuDNN", ("conv", "gemm", "xmma", "cudnn",
                                            "cutlass", "sm90", "implicit",
                                            "fprop", "winograd", "fft")))


def require(cond, msg):
    if not cond:
        raise RuntimeError("chip_smoke: " + msg)


def kernel_wrappers():
    """Each kernel's wrapper, whose ``launches`` counts its launches."""
    return {"pool_leaky": pool.maxpool2_leaky,
            "input_stage": ist.input_stage,
            "routing": routing.routed_capsules,
            "routing_bwd": routing.routed_capsules_backward}


def reset_launches():
    for fn in kernel_wrappers().values():
        fn.launches = 0


def read_launches():
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def time_ms(fn, iters=20, warmup=3, cold=False):
    """Mean CUDA-event time of ``fn`` per call.  ``cold``: before every
    call, outside the timed span, write FLUSH_BYTES (more than the L2)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if cold:
        buf = torch.empty(FLUSH_BYTES // 4, device="cuda")
        spans = []
        for _ in range(iters):
            buf.fill_(1.0)
            span = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
            span[0].record()
            fn()
            span[1].record()
            spans.append(span)
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in spans) / iters
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes, n_flop, dtype):
    """Least time for the work: bytes over HBM rate or operations over
    the card's peak for ``dtype`` (a key of FLOP_PER_S), whichever is
    larger, and which."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flop / FLOP_PER_S[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def check_pool():
    """Phase 3: K1 against its plain version; returns max abs err (f32)."""
    g = torch.Generator(device="cuda").manual_seed(1)
    worst = 0.0
    for shape in POOL_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(shape, generator=g, device="cuda").to(dtype)
            got = pool.maxpool2_leaky(x)
            torch.cuda.synchronize()
            want = pool.maxpool2_leaky_plain(x)
            err = (got.float() - want.float()).abs().max().item()
            print(f"[K1] pool_leaky {shape} {str(dtype)[6:]}: max_abs_err "
                  f"{err}")
            if dtype == torch.float32:
                require(torch.equal(got, want), "K1 f32 not bit-exact")
                worst = max(worst, err)
            else:
                require(err <= 1e-2, f"K1 bf16 err {err} > 1e-2")
    return worst


def pixel_operands(shape, g):
    """0-255 integer frames and a conv1 at the serving slice's scale:
    He-normal weights with BN folded from the frames' own statistics
    (unit-scale outputs after a large cancellation)."""
    x = torch.randint(0, 256, shape, generator=g, device="cuda").float()
    w0 = (torch.randn((3, 3, 3, 32), generator=g, device="cuda",
                      dtype=torch.float64) * (2 / 27) ** 0.5)
    y = F.conv2d(x.double().permute(0, 3, 1, 2), w0.permute(3, 2, 0, 1),
                 padding=1)
    scale = (y.var((0, 2, 3)) + 1e-5).rsqrt()
    return (x, (w0 * scale).float().contiguous(),
            (-y.mean((0, 2, 3)) * scale).float())


def check_input_stage_pixels(shape, g):
    """Phase 4, K2 f32 on 0-255 frames against the plain version in f64:
    rtol 1e-5, atol 1e-5 of the largest output."""
    x, w, b = pixel_operands(shape, g)
    _build.fill_shared_memory(float("nan"))
    got = ist.input_stage(x, w, b)
    torch.cuda.synchronize()
    want = ist.input_stage_apply(
        x.double(), *ist.phase_kernel(w.double(), b.double()), 32)
    atol = 1e-5 * want.abs().max().item()
    err = (got.double() - want).abs()
    print(f"[K2] input_stage {shape} float32 on 0-255 frames: max_abs_err "
          f"{err.max().item()} vs f64 (band rtol 1e-5, atol {atol})")
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=atol)
    require(torch.equal(got, ist.input_stage(x, w, b)),
            "K2 f32: two calls differ")


def check_input_stage():
    """Phase 4: K2 against its plain version; returns the max abs error
    per dtype at darknet_r's shape (f32 against the plain version, bf16
    against the one-rounding reference)."""
    g = torch.Generator(device="cuda").manual_seed(2)
    out = {}
    for shape in K2_SHAPES:
        x = torch.rand(shape, generator=g, device="cuda") * 2 - 1
        w = 0.3 * torch.randn((3, 3, 3, 32), generator=g, device="cuda")
        b = torch.randn((32,), generator=g, device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            xd, wd = x.to(dtype), w.to(dtype).float()  # what the kernel serves
            # NaN wherever the kernel reads shared memory it never wrote
            _build.fill_shared_memory(float("nan"))
            got = ist.input_stage(xd, wd, b)
            torch.cuda.synchronize()
            wp, bp = ist.phase_kernel(wd, b)
            want = ist.input_stage_apply(xd, wp, bp, 32)
            err = (got.float() - want.float()).abs()
            name = f"[K2] input_stage {shape} {str(dtype)[6:]}"
            if dtype == torch.float32:
                print(f"{name}: max_abs_err {err.max().item()} mean "
                      f"{err.mean().item()}; two calls bit-identical")
                torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
                require(torch.equal(got, ist.input_stage(xd, wd, b)),
                        "K2 f32: two calls differ")
            else:
                # the plain bf16 path rounds the conv and the bias apart
                require(err.mean().item() < 5e-3 and err.max().item() < 0.1,
                        "K2 bf16 outside its band")
                one = ist.input_stage_apply(xd.float(), wp, bp, 32).to(dtype)
                torch.testing.assert_close(got.float(), one.float(),
                                           **K2_BF16_TOL)
                require(torch.equal(got, ist.input_stage(xd, wd, b)),
                        "K2 bf16: two calls differ")
                err1 = (got.float() - one.float()).abs()
                print(f"{name}: vs the plain bf16 path max_abs_err "
                      f"{err.max().item()} mean {err.mean().item()}; vs one "
                      f"rounding max_abs_err {err1.max().item()}, "
                      f"{int((err1 > 0).sum())} of {err1.numel()} differ; "
                      "two calls bit-identical")
                err = err1
            if shape == K2_SHAPES[0]:
                out[dtype] = err.max().item()
    g = torch.Generator(device="cuda").manual_seed(5)
    for shape in K2_SHAPES:
        check_input_stage_pixels(shape, g)
    return out


def seeded_darknet(frames_u8, seed=0, n_boxes=1, n_classes=43):
    """Full-width DarkNet (darknet_r's head by default, darknet_d's with
    n_boxes=2, n_classes=0) with weights from a torch.Generator.

    Convs get He-normal weights; BN scale/bias are random; BN running
    statistics are measured on a few scenes and then randomly perturbed,
    so every layer sees unit-scale activations and the fold is not
    trivial; the head's scale spreads confidences over (0, 1)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    model = DarkNet(n_boxes=n_boxes, n_classes=n_classes).cuda()
    with torch.no_grad():
        for name, t in model.named_parameters():
            if name.endswith("conv_19.weight"):
                t.normal_(0.0, 2.0 / t[0].numel() ** 0.5, generator=g)
            elif ".conv_" in name:
                t.normal_(0.0, (2.0 / t[0].numel()) ** 0.5, generator=g)
            elif name.endswith(".weight"):   # BN scale
                t.copy_(1 + 0.1 * torch.randn(t.shape, generator=g,
                                              device="cuda"))
            else:                            # BN bias
                t.normal_(0.0, 0.1, generator=g)
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.momentum = None   # running stats = mean over the batches
        model.train()
        x = torch.from_numpy(frames_u8[:8]).cuda().float()
        model(x)
        model.eval()
        for name, t in model.named_buffers():
            if name.endswith("running_var"):
                t.mul_(1 + 0.1 * torch.rand(t.shape, generator=g,
                                            device="cuda"))
            elif name.endswith("running_mean"):
                t.add_(0.05 * torch.randn(t.shape, generator=g,
                                          device="cuda") * t.abs().mean())
    return model


def box_conf(y, n_boxes):
    """The confidences (b, g, g, B) of a (b, g, g, 5B + C) grid."""
    return y[..., :5 * n_boxes].reshape(y.shape[:3] + (n_boxes, 5))[..., 0]


def compare_boxes(boxes, want, y_hat, ref, th, tol, n_boxes=1,
                  n_classes=43):
    """The f32 box lists against the reference's, candidate by candidate
    (cell and box, the lists' grid-scan order).

    Candidates whose reference confidence lies within ``tol`` of the
    threshold may fall either way and are left out (and counted); all
    others must be kept or dropped alike, with the same image, order and
    corners, and the same class (when C > 0) unless the reference's top
    two class scores tie within ``tol``.  Returns (boxes compared,
    candidates left out, classes differing at ties)."""
    conf_ref = box_conf(ref, n_boxes)
    near = np.abs(conf_ref - th) <= tol
    got_valid, want_valid = box_conf(y_hat, n_boxes) > th, conf_ref > th
    require(np.array_equal(got_valid[~near], want_valid[~near]),
            "kept boxes differ away from the threshold")
    keep_got, keep_want = ~near[got_valid], ~near[want_valid]
    require(np.array_equal(boxes[0][keep_got], want[0][keep_want]),
            "box image indices or order differ")
    require(np.allclose(boxes[1][keep_got], want[1][keep_want], rtol=0,
                        atol=1e-2), "box corners differ beyond 0.01 px")
    if n_classes == 0:
        require(boxes[2] is None and want[2] is None, "classes at C = 0")
        return int(keep_want.sum()), int(near.sum()), 0
    top2 = np.sort(ref[..., 5 * n_boxes:], axis=-1)[..., -2:]
    tied = np.broadcast_to(((top2[..., 1] - top2[..., 0]) <= tol)[..., None],
                           near.shape)[want_valid][keep_want]
    differ = boxes[2][keep_got] != want[2][keep_want]
    require(not (differ & ~tied).any(), "box classes differ beyond ties")
    return int(keep_want.sum()), int(near.sum()), int(differ.sum())


def run_slice(frames, y_true, model_dir, params):
    """Phase 5 (darknet_r) and 18 (darknet_d): the detector of ``params``
    through dark_pred, f32 then bf16; returns each run's launch counts."""
    nb, nc = int(params.n_boxes), int(params.n_classes)
    model = predict.restore_darknet(params, model_dir, "last").cuda()
    with torch.no_grad():
        ref = torch.cat([model(torch.from_numpy(frames[i:i + BATCH]).cuda()
                               .float()) for i in range(0, len(frames),
                                                        BATCH)])
    ref_np = ref.cpu().numpy()
    conf = box_conf(ref_np, nb).ravel()
    runs = {}
    print(f"[slice] reference confidences: min {conf.min()} max "
          f"{conf.max()} mean {conf.mean()}")

    for dtype in ("float32", "bfloat16"):
        params.compute_dtype = dtype
        reset_launches()
        t0 = time.perf_counter()
        y_hat, boxes = predict.dark_detect(list(frames), model_dir, params,
                                           "last", device="cuda")
        wall = time.perf_counter() - t0
        launches = read_launches()
        n_batches = -(-len(frames) // BATCH)
        print(f"[slice] {dtype}: dark_pred over {len(frames)} scenes in "
              f"{wall:.3f} s (host clock, restore and fold included); "
              f"launches {launches} for {n_batches} batches")
        require(launches == {"input_stage": n_batches,
                             "pool_leaky": 4 * n_batches, "routing": 0,
                             "routing_bwd": 0},
                f"{dtype}: kernel launches {launches}")
        require(y_hat.shape == ref_np.shape and np.isfinite(y_hat).all(),
                f"{dtype}: y_hat shape/finite")
        err = np.abs(y_hat - ref_np)
        print(f"[slice] {dtype}: y_hat vs eval DarkNet max_abs_err "
              f"{err.max()} mean {err.mean()}")
        if dtype == "float32":
            require(err.max() <= 5e-4, "f32 y_hat outside atol 5e-4")
            want = decode.to_flat_host(
                decode.decode_grid(ref, n_classes=nc, n_boxes=nb,
                                   img_size=448),
                image_hw=np.array([f.shape[:2] for f in frames]),
                img_size=448, with_classes=nc != 0)
            n, n_near, n_tied = compare_boxes(boxes, want, y_hat, ref_np,
                                              0.5, 2 * float(err.max()),
                                              nb, nc)
            print(f"[slice] f32 box lists equal: {n} boxes compared, "
                  f"{n_near} candidates within {2 * err.max()} of the "
                  f"threshold left out, {n_tied} classes differing at tied "
                  "scores")
        else:
            # per channel group: the confidence (sigmoid, mean ~0.57)
            # carries most of the drift; the 43 class probabilities
            # (softmax, mean ~0.023) need a band of their own
            box_err = err[..., :5 * nb].reshape(err.shape[:3] + (nb, 5))
            groups = {"confidence": box_err[..., 0],
                      "box": box_err[..., 1:5]}
            if nc:
                groups["class"] = err[..., 5 * nb:]
            means = {k: float(v.mean()) for k, v in groups.items()}
            print(f"[slice] bf16: mean_abs_err by channel group {means}")
            require(err.max() < 0.15, "bf16 y_hat outside max 0.15")
            for k, v in means.items():
                require(v < BF16_BANDS[k],
                        f"bf16 {k} channels outside mean {BF16_BANDS[k]}")
        ap, acc = (det.detect_AP(y_true, y_hat, params),
                   det.detect_acc(y_true, y_hat, params))
        require(np.isfinite(ap) and np.isfinite(acc), "metrics not finite")
        print(f"[slice] {dtype}: detect_AP {ap} detect_acc {acc} "
              "(random weights: a finiteness check only)")
        runs[dtype] = launches
    return runs


def time_pool():
    """K1 at the four pool shapes, f32; returns per-batch sums.

    K1's plain version is the PyTorch yardstick itself (max_pool2d then
    leaky_relu on the channels_last view), so one timing serves as both
    plain_ms and library_ms."""
    g = torch.Generator(device="cuda").manual_seed(3)
    k1 = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    for shape in POOL_SHAPES:
        x = torch.randn(shape, generator=g, device="cuda")
        t = {"ms": time_ms(lambda: pool.maxpool2_leaky(x)),
             "plain_ms": time_ms(lambda: pool.maxpool2_leaky_plain(x))}
        n = x.numel()  # read n, write n/4 (f32); ~4 operations per output
        t["bound_ms"], _ = bound_ms(4 * n + n, n, torch.float32)
        for k in k1:
            k1[k] += t[k]
        print(f"[time] pool_leaky {shape} f32: kernel {t['ms']:.4f} ms, "
              f"bound {t['bound_ms']:.4f} ms (bytes), plain = "
              f"max_pool2d+leaky_relu {t['plain_ms']:.4f} ms")
    k1["library_ms"] = k1["plain_ms"]
    return k1


def time_input_stage(sd):
    """K2 at [32, 448, 448, 3] with the slice's folded conv1, per dtype."""
    g = torch.Generator(device="cuda").manual_seed(4)
    k2 = {}
    for dtype in (torch.float32, torch.bfloat16):
        s = 4 if dtype == torch.float32 else 2
        x = (torch.rand((BATCH, 448, 448, 3), generator=g, device="cuda")
             * 255).to(dtype)
        p = ist.prepare_serving(sd, dtype)
        w, b = p["input"]["w"], p["input"]["b"]
        wp, bp = ist.phase_kernel(w, b)
        w_oihw = w.permute(3, 2, 0, 1).to(
            dtype=dtype, memory_format=torch.channels_last)
        xv = x.permute(0, 3, 1, 2)
        t = {"ms": time_ms(lambda: ist.input_stage(x, w, b)),
             "plain_ms": time_ms(
                 lambda: ist.input_stage_apply(x, wp, bp, 32)),
             "library_ms": time_ms(lambda: F.leaky_relu(F.max_pool2d(
                 F.conv2d(xv, w_oihw, b.to(dtype), padding=1), 2, 2), 0.1))}
        n_in, n_out = x.numel(), BATCH * 224 * 224 * 32
        n_bytes = s * (n_in + n_out) + 4 * (864 + 32)
        n_flop = BATCH * 448 * 448 * 32 * 27 * 2
        cold = time_ms(lambda: ist.input_stage(x, w, b), cold=True)
        if dtype == torch.float32:
            # three split products on the TF32 tensor cores; beside it the
            # bound on the f32 CUDA cores, which the FMA kernel had
            t["bound_ms"], t["bound_by"] = bound_ms(n_bytes, 3 * n_flop,
                                                    "tf32")
            fma_ms, _ = bound_ms(n_bytes, n_flop, dtype)
            design = "3xTF32 mma.sync, TF32 tensor cores"
            extra = (f"; the ops at TF32's rate "
                     f"{3 * n_flop / FLOP_PER_S['tf32'] * 1e3:.4f} ms; on "
                     f"the f32 CUDA cores {fma_ms:.4f} ms")
        else:
            t["bound_ms"], t["bound_by"] = bound_ms(n_bytes, n_flop, dtype)
            design, extra = "mma.sync, bf16 tensor cores", ""
        print(f"[time] input_stage {tuple(x.shape)} {str(dtype)[6:]} "
              f"({design}): kernel {t['ms']:.4f} ms (L2 flushed "
              f"{cold:.4f}), "
              f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}{extra}), "
              f"share of the bound {t['bound_ms'] / t['ms']:.3f}, plain "
              f"{t['plain_ms']:.4f} ms, conv2d+max_pool2d+leaky_relu "
              f"{t['library_ms']:.4f} ms")
        k2[dtype] = t
    return k2


def group_of(name, groups=GROUPS):
    low = name.lower()
    for group, keys in groups:
        if any(k in low for k in keys):
            return group
    return "other"


def profile_ms(fn, wall_ms, iters=5, groups=GROUPS, top=10):
    """Where ``fn``'s device time goes, per call: prints the kernel time
    by group, the device busy share (kernel time over ``wall_ms``, the
    CUDA-event time of one call) and the ten longest kernels."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    # kernels only: an operator's entry also carries its kernels' time,
    # and a record_function range on the device timeline (the
    # optimizer's "Optimizer.step#Adam.step") spans kernels counted apart
    kernels = [(e.key, e.self_device_time_total / 1e3 / iters, e.count)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0
               and not e.key.startswith("Optimizer.")]
    total = sum(t for _, t, _ in kernels)
    print(f"[profile]   kernel time {total:.4f} ms/iter; device busy "
          f"{total / wall_ms:.3f}")
    require(total > 0, "the profiler saw no device time")
    by_group = {}
    for key, t, _ in kernels:
        g = group_of(key, groups)
        by_group[g] = by_group.get(g, 0.0) + t
    for group, t in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"[profile]   {group:14s} {t:9.4f} ms  {t / total:6.3f} of "
              "kernel time")
    # the profiler can drop a few events at the start of its window;
    # launches/iter below 1 per expected launch shows it
    print("[profile]   longest kernels (ms/iter, launches/iter, ms/launch):")
    for key, t, count in sorted(kernels, key=lambda k: -k[1])[:top]:
        print(f"[profile]   {t:9.4f}  {count / iters:5.1f}  "
              f"{t * iters / count:8.4f}  {key[:100]}")


def time_serving(model, frames, name="darknet_r"):
    """Serving forward + decode at batch 32 on device-resident frames:
    CUDA-event wall time, then the profile of the same calls.  Returns
    the ms per batch by dtype."""
    nb, nc = model.n_boxes, model.n_classes
    sd = model.state_dict()
    x = torch.from_numpy(frames[:BATCH]).cuda().float()
    times = {}
    for dtype in (torch.float32, torch.bfloat16):
        p = ist.prepare_serving(sd, dtype)

        def fwd_decode():
            y = ist.darknet_serving_apply(p, x, n_boxes=nb, n_classes=nc,
                                          dtype=dtype)
            return decode.decode_grid(y, n_classes=nc, n_boxes=nb,
                                      img_size=448)

        with torch.inference_mode():
            ms = time_ms(fwd_decode, iters=10)
            ms_model = (time_ms(lambda: model(x), iters=10)
                        if dtype == torch.float32 else None)
            extra = ("" if ms_model is None else
                     f"; eval DarkNet forward (cuDNN, BN unfolded, no "
                     f"kernels) {ms_model:.3f} ms = "
                     f"{BATCH / ms_model * 1e3:.1f} img/s")
            print(f"[time] {name} serving forward+decode batch {BATCH} "
                  f"{str(dtype)[6:]}: {ms:.3f} ms = "
                  f"{BATCH / ms * 1e3:.1f} img/s{extra} ({SMI})")
            profile_ms(fwd_decode, ms)
        times[dtype] = ms
    return times


def check_routing():
    """Phase 7: K3 against its plain version; returns the f32 max abs
    error at CapsuleNet's shape."""
    g = torch.Generator(device="cuda").manual_seed(5)
    worst = None
    for (b, n, k), scale in (((CAPS_BATCH, 1296, 43), 1.0),
                             ((3, 150, 5), 1.0),      # partial tiles, groups
                             ((CAPS_BATCH, 1296, 43), 10.0)):  # saturates
        x = scale * torch.randn((b, n, 8), generator=g, device="cuda")
        # 0.1 N(0, 1), as models/init.py draws the route weights
        w = 0.1 * torch.randn((n, k, 8, 16), generator=g, device="cuda")
        for bf16 in (False, True):
            io = torch.bfloat16 if bf16 else torch.float32
            xi, wi = x.to(io), w.to(io)
            # NaN wherever the kernel reads shared memory it never wrote
            _build.fill_shared_memory(float("nan"))
            got = routing.routed_capsules(xi, wi, 3, bf16=bf16)
            torch.cuda.synchronize()
            want = routing.routed_capsules_plain(x, w, 3, bf16=bf16)
            err = (got - want).abs().max().item()
            print(f"[K3] routing x {(b, n, 8)} scale {scale} w {(n, k, 8, 16)}"
                  f" {'bf16' if bf16 else 'f32'}: max_abs_err {err}, caps "
                  f"|max| {want.abs().max().item()}")
            torch.testing.assert_close(got, want, **K3_TOL[bf16])
            if worst is None:
                worst = err
    return worst


def seeded_capsulenet(seed=0):
    """Full-width CapsuleNet (43 classes) with torch-default init from
    ``seed``; the two convs are scaled (x3, x10) so the primary capsules
    are near unit length and the class scores spread out."""
    model = CapsuleNet(n_classes=43, seed=seed)
    with torch.no_grad():
        model.conv1.weight.mul_(3.0)
        for m in model.primary_capsules.capsules:
            m.weight.mul_(10.0)
    return model


def plain_scores(model, x, dtype):
    """Eval forward of ``model`` in ``dtype`` with the plain routing."""
    with torch.inference_mode():
        h = F.relu(F.conv2d(x.permute(0, 3, 1, 2).to(dtype),
                            model.conv1.weight.to(dtype),
                            model.conv1.bias.to(dtype)))
        u = model.primary_capsules(h, dtype)
        w = model.traffic_sign_capsules.route_weights[0]
        return caps.capsule_norm(routing.routed_capsules_plain(
            u, w, 3, bf16=dtype == torch.bfloat16))


def run_capsule_slice(crops, y_true, model_dir, params):
    """Phase 8: the capsule slice through class_pred, f32 then bf16;
    returns the f32 run's launch counts."""
    model = predict.restore_capsule(params, model_dir, "last").cuda()
    n_batches = -(-len(crops) // CAPS_BATCH)
    refs = {}
    for dtype in ("float32", "bfloat16"):
        refs[dtype] = ref_np = torch.cat([plain_scores(
            model, torch.from_numpy(crops[i:i + CAPS_BATCH]).cuda(),
            getattr(torch, dtype)) for i in range(0, len(crops),
                                                  CAPS_BATCH)]).cpu().numpy()
        print(f"[capsule] {dtype} reference scores (plain routing): min "
              f"{ref_np.min()} max {ref_np.max()} std {ref_np.std()}; "
              f"argmax classes used {len(np.unique(ref_np.argmax(1)))} of 43")
    print("[capsule] bf16 reference vs f32 reference: max_abs_diff "
          f"{np.abs(refs['bfloat16'] - refs['float32']).max()}")
    for dtype in ("float32", "bfloat16"):
        ref_np = refs[dtype]
        params.compute_dtype = dtype
        reset_launches()
        t0 = time.perf_counter()
        y_hat, classes = predict.class_pred(crops, model_dir, params, "last",
                                            device="cuda")
        wall = time.perf_counter() - t0
        launches = read_launches()
        print(f"[capsule] {dtype}: class_pred over {len(crops)} crops in "
              f"{wall:.3f} s (host clock, restore included); launches "
              f"{launches} for {n_batches} batches")
        require(launches == {"routing": n_batches, "routing_bwd": 0,
                             "pool_leaky": 0, "input_stage": 0},
                f"{dtype}: kernel launches {launches}")
        require(y_hat.shape == ref_np.shape and np.isfinite(y_hat).all(),
                f"{dtype}: scores shape/finite")
        err = np.abs(y_hat - ref_np)
        print(f"[capsule] {dtype}: scores vs the {dtype} plain-routing "
              f"forward max_abs_err {err.max()} mean {err.mean()}")
        np.testing.assert_allclose(y_hat, ref_np,
                                   **K3_TOL[dtype == "bfloat16"])
        top2 = np.sort(ref_np, axis=1)[:, -2:]
        tied = top2[:, 1] - top2[:, 0] <= 2 * err.max()
        differ = classes != ref_np.argmax(1)
        require(not (differ & ~tied).any(), f"{dtype}: classes differ "
                "away from ties")
        print(f"[capsule] {dtype}: argmax classes equal but {differ.sum()} "
              f"(of {tied.sum()} crops whose top two reference scores tie "
              f"within {2 * err.max()})")
        metrics = {"recog_pr": clsm.recog_pr(y_true, y_hat, params),
                   "recog_acc": clsm.recog_acc(y_true, y_hat, params),
                   "recog_auc": clsm.recog_auc(y_true, y_hat, params)}
        require(all(np.isfinite(v) for v in metrics.values()),
                f"{dtype}: metrics not finite")
        print(f"[capsule] {dtype}: {metrics} (random weights: a finiteness "
              "check only)")
        if dtype == "float32":
            f32_launches = launches
    return f32_launches


def routing_bound(b, n, k, bf16, n_iter=3):
    """K3's least time: votes 2*B*N*K*8*16 (tensor cores in bf16) plus
    2 * n_iter - 1 node-sized routing passes of 2*B*N*K*16 in f32 on
    the CUDA cores; bytes are x and W in their type and the f32 caps."""
    s = 2 if bf16 else 4
    n_bytes = s * (b * n * 8 + n * k * 8 * 16) + 4 * b * k * 16
    votes = 2 * b * n * k * 8 * 16
    passes = (2 * n_iter - 1) * 2 * b * n * k * 16
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = (votes / FLOP_PER_S[torch.bfloat16 if bf16 else torch.float32]
             + passes / FLOP_PER_S[torch.float32]) * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", n_bytes, votes, passes)


def count_kernels(fn):
    """CUDA kernels one call of ``fn`` issues (torch.profiler)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0)


def launch_breakdown(fn, label, calls=3):
    """Device time of each CUDA kernel one call of ``fn`` issues, in issue
    order, averaged over ``calls`` profiled calls (torch.profiler); prints
    one line per launch and returns [(name, ms)]."""
    per_call = count_kernels(fn)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls + 1):   # the first call may lose events
            fn()
            torch.cuda.synchronize()
    kernels = sorted((e.time_range.start, e.name, e.time_range.elapsed_us())
                     for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA)
    kernels = kernels[-calls * per_call:]
    if len(kernels) < calls * per_call:  # a measurement, not a check
        print(f"[breakdown] {label}: the profiler saw {len(kernels)} of "
              f"{calls * per_call} kernels; no breakdown")
        return []
    out = []
    for i in range(per_call):
        name = kernels[i][1]
        ms = sum(kernels[c * per_call + i][2] for c in range(calls)) / calls
        out.append((name, ms / 1e3))
    total = sum(ms for _, ms in out)
    print(f"[breakdown] {label}: {per_call} launches, {total:.4f} ms of "
          "kernel time per call:")
    for i, (name, ms) in enumerate(out):
        print(f"[breakdown]   {i}  {ms:8.4f} ms  {name[:90]}")
    return out


def time_routing(w_model):
    """K3 at CapsuleNet's shape with the slice's route weights, per
    dtype: kernel, plain version, bound, kernels per call."""
    g = torch.Generator(device="cuda").manual_seed(6)
    x = torch.randn((CAPS_BATCH, 1296, 8), generator=g, device="cuda")
    out = {}
    for bf16 in (False, True):
        io = torch.bfloat16 if bf16 else torch.float32
        xi, wi = x.to(io), w_model.to(io)  # operands as the kernel reads them
        t = {"ms": time_ms(lambda: routing.routed_capsules(xi, wi, 3, bf16)),
             "cold_ms": time_ms(lambda: routing.routed_capsules(
                 xi, wi, 3, bf16), cold=True),
             # one iteration: the votes pass alone, no logits or softmax
             "ms_1": time_ms(lambda: routing.routed_capsules(xi, wi, 1, bf16)),
             "plain_ms": time_ms(lambda: routing.routed_capsules_plain(
                 x, w_model, 3, bf16))}
        t["bound_ms"], t["bound_by"], nb, votes, passes = routing_bound(
            CAPS_BATCH, 1296, 43, bf16)
        t["kernels"] = count_kernels(
            lambda: routing.routed_capsules(xi, wi, 3, bf16))
        name = "bf16" if bf16 else "f32"
        print(f"[time] routing x {tuple(x.shape)} w {tuple(w_model.shape)} "
              f"{name}: kernel {t['ms']:.4f} ms ({t['kernels']} CUDA kernels "
              f"per call), bound {t['bound_ms']:.4f} ms ({t['bound_by']}: "
              f"{nb} bytes, votes {votes} + routing {passes} FLOP), plain "
              f"(compute_priors+dynamic_routing) {t['plain_ms']:.4f} ms; "
              f"n_iter 1 (votes pass + squash) {t['ms_1']:.4f} ms, each "
              f"later iteration {(t['ms'] - t['ms_1']) / 2:.4f} ms; L2 "
              f"flushed before each call {t['cold_ms']:.4f} ms")
        launch_breakdown(lambda: routing.routed_capsules(xi, wi, 3, bf16),
                         f"routing {name}")
        out[bf16] = t
    return out


def time_capsule_serving(model, crops):
    """CapsuleNet serving forward at batch 64 on device-resident crops:
    CUDA-event wall time, then the profile of the same calls."""
    x = torch.from_numpy(crops[:CAPS_BATCH]).cuda()
    for dtype in (torch.float32, torch.bfloat16):
        model.dtype = dtype
        with torch.inference_mode():
            ms = time_ms(lambda: model(x), iters=10)
            print(f"[time] capsule serving forward batch {CAPS_BATCH} "
                  f"{str(dtype)[6:]}: {ms:.3f} ms = "
                  f"{CAPS_BATCH / ms * 1e3:.1f} img/s")
            profile_ms(lambda: model(x), ms)
    model.dtype = torch.float32


def grad_close(name, got, want, bf16, scaled=False):
    """K4_TOL for one gradient; ``scaled`` multiplies the f32 atol by the
    gradient's largest value (f32 sums of large terms in another order).
    Returns the max abs error."""
    big = want.abs().max().item()
    tol = K4_TOL[bf16]
    atol = tol["atol"] * (big if bf16 else (max(1.0, big) if scaled else 1))
    err = (got - want).abs().max().item()
    torch.testing.assert_close(got, want, rtol=tol["rtol"], atol=atol,
                               msg=lambda m: f"{name}: {m}")
    return err


def check_routing_bwd():
    """Phase 10: K4 against its plain version; returns the f32 max abs
    error (dx and dW) at CapsuleNet's shape."""
    g = torch.Generator(device="cuda").manual_seed(7)
    worst = None
    for (b, n, k), scale in (((CAPS_BATCH, 1296, 43), 1.0),
                             ((3, 150, 5), 1.0),      # partial tiles, groups
                             ((CAPS_BATCH, 1296, 43), 10.0)):  # saturates
        x = scale * torch.randn((b, n, 8), generator=g, device="cuda")
        w = 0.1 * torch.randn((n, k, 8, 16), generator=g, device="cuda")
        cot = torch.randn((b, k, 16), generator=g, device="cuda")
        for bf16 in (False, True):
            io = torch.bfloat16 if bf16 else torch.float32
            _, s = routing.routing_states_plain(x, w, 3, bf16)
            xi, wi = x.to(io), w.to(io)
            _build.fill_shared_memory(float("nan"))  # as in phase 7
            dx, dw = routing.routed_capsules_backward(xi, wi, s, cot, 3, bf16)
            torch.cuda.synchronize()
            want = routing.routed_capsules_backward_plain(x, w, s, cot, 3,
                                                          bf16)
            errs = [grad_close(f"K4 {name}", got, ref, bf16, scale > 1)
                    for name, got, ref in zip(("dx", "dW"), (dx, dw), want)]
            print(f"[K4] routing_bwd x {(b, n, 8)} scale {scale} w "
                  f"{(n, k, 8, 16)} {'bf16' if bf16 else 'f32'}: dx "
                  f"max_abs_err {errs[0]} (|dx| max "
                  f"{want[0].abs().max().item()}), dW max_abs_err {errs[1]} "
                  f"(|dW| max {want[1].abs().max().item()})")
            if worst is None:
                worst = max(errs)
    # the autograd op (K3 forward saving s_t, K4 backward) against
    # torch.autograd through the plain forward
    x = torch.randn((16, 1296, 8), generator=g, device="cuda")
    w = 0.1 * torch.randn((1296, 43, 8, 16), generator=g, device="cuda")
    cot = torch.randn((16, 43, 16), generator=g, device="cuda")
    grads = []
    for fn in (routing.routed_capsules, routing.routed_capsules_plain):
        xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
        (fn(xa, wa, 3) * cot).sum().backward()
        grads.append((xa.grad, wa.grad))
    errs = [grad_close(f"autograd {name}", a, b, False)
            for name, a, b in zip(("dx", "dW"), *grads)]
    print(f"[K4] autograd op vs torch.autograd through the plain forward "
          f"(B 16, f32): dx max_abs_err {errs[0]}, dW max_abs_err {errs[1]}")
    return worst


def plain_loss(model, x, y, cfg):
    """CapsuleNet's training loss with the plain routing, in the model's
    dtype (the same convs, casts and decoder as CapsuleNet.forward)."""
    dt = model.dtype
    h = F.relu(F.conv2d(x.permute(0, 3, 1, 2).to(dt),
                        model.conv1.weight.to(dt), model.conv1.bias.to(dt)))
    u = model.primary_capsules(h, dt)
    caps_out = routing.routed_capsules_plain(
        u, model.traffic_sign_capsules.route_weights[0], 3,
        bf16=dt == torch.bfloat16)
    t = caps_out[torch.arange(caps_out.shape[0], device=x.device), y]
    loss, _ = losses.capsule_loss(caps.capsule_norm(caps_out), y, cfg, x,
                                  model.decoder(t, dt))
    return loss


def check_train_step(params, crops, labels):
    """Phase 11, on one batch of 64: every gradient finite and non-zero
    after a step; one step's gradients against the plain routing's."""
    cfg = losses.LossConfig.from_params(params)
    x = torch.from_numpy(crops[:CAPS_BATCH]).cuda()
    y = torch.from_numpy(labels[:CAPS_BATCH]).cuda()
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        model = seeded_capsulenet().cuda().train()
        model.dtype = dtype
        grads = []
        for use_kernel in (True, False):
            model.zero_grad(set_to_none=True)
            loss = (steps.loss_and_scores(model, x, y, cfg, "capsule")[0]
                    if use_kernel else plain_loss(model, x, y, cfg))
            loss.backward()
            grads.append({n: p.grad.clone()
                          for n, p in model.named_parameters()})
        worst = {}
        for name, got in grads[0].items():
            require(torch.isfinite(got).all() and got.abs().max() > 0,
                    f"{dtype}: gradient of {name} not finite or all zero")
            worst[name] = grad_close(f"step {name}", got, grads[1][name],
                                     bf16, scaled=True)
        print(f"[train] {str(dtype)[6:]} one step on a batch of "
              f"{CAPS_BATCH}: every gradient finite and non-zero; against "
              f"the plain routing max_abs_err per parameter "
              f"{ {k: float(f'{v:.3g}') for k, v in worst.items()} }")
        opt = steps.make_optimizer(model)
        loss, _, _ = steps.train_step(model, opt, x, y, 1e-3, cfg, "capsule")
        require(torch.isfinite(loss).item(), f"{dtype}: step loss")
        require(all(torch.isfinite(p).all() for p in model.parameters()),
                f"{dtype}: parameters not finite after an Adam step")


def run_train_slice(params, model_root):
    """Phase 11: train_and_evaluate at batch 64, f32 then bf16; returns
    the f32 run's launch counts."""
    n_train = -(-TRAIN_CROPS // CAPS_BATCH)
    n_eval = -(-EVAL_CROPS // CAPS_BATCH)
    out = {}
    for dtype in ("float32", "bfloat16"):
        params.compute_dtype = dtype
        model_dir = os.path.join(model_root, dtype)
        os.makedirs(model_dir, exist_ok=True)
        np.random.seed(0)
        reset_launches()
        t0 = time.perf_counter()
        driver.train_and_evaluate(params, os.path.join(model_root, "nodata"),
                                  model_dir, seed=0, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        losses_tr = np.load(os.path.join(model_dir, "losses_tr.npy"))
        print(f"[train] {dtype}: train_and_evaluate, {TRAIN_EPOCHS} epochs "
              f"of {n_train} train + {n_eval} eval batches of {CAPS_BATCH}, "
              f"in {wall:.3f} s (host clock, init, data and checkpoints "
              f"included); launches {launches}; train losses {losses_tr}")
        require(launches == {"routing": (n_train + n_eval) * TRAIN_EPOCHS,
                             "routing_bwd": n_train * TRAIN_EPOCHS,
                             "pool_leaky": 0, "input_stage": 0},
                f"{dtype}: kernel launches {launches}")
        require(np.isfinite(losses_tr).all() and losses_tr[-1] < losses_tr[0],
                f"{dtype}: the train loss did not fall: {losses_tr}")
        _, _, crops, _ = loader.synthetic_dataset("capsule", params, 0, 64)
        y_hat, _ = predict.class_pred(crops, model_dir, params, "last",
                                      device="cuda")
        require(y_hat.shape == (64, 43) and np.isfinite(y_hat).all(),
                f"{dtype}: scores from the trained last.ckpt")
        print(f"[train] {dtype}: class_pred restored last.ckpt from "
              f"{model_dir}{params.train_frac}: scores finite, "
              f"{y_hat.shape}")
        out[dtype] = launches
    return out["float32"]


def routing_bwd_bound(b, n, k, bf16, n_iter=3):
    """K4's least time: the votes, dx and dW, 2*B*N*K*8*16 each (tensor
    cores in bf16), plus 5 * n_iter - 4 node-sized passes of 2*B*N*K*16
    in f32 on the CUDA cores (the logits rebuilt from the saved state,
    then per iteration the node-sum VJP and, but for the first, the
    probabilities' VJP, vbar and the agreement VJP); bytes are x and W
    in their type, s_saved and g read, dx and dW (f32) written."""
    s = 2 if bf16 else 4
    n_bytes = (s * (b * n * 8 + n * k * 8 * 16)
               + 4 * (n_iter + 1) * b * k * 16
               + 4 * (b * n * 8 + n * k * 8 * 16))
    products = 3 * 2 * b * n * k * 8 * 16
    passes = (5 * n_iter - 4) * 2 * b * n * k * 16
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = (products / FLOP_PER_S[torch.bfloat16 if bf16 else torch.float32]
             + passes / FLOP_PER_S[torch.float32]) * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", n_bytes, products, passes)


def time_routing_bwd(w_model):
    """K4 at CapsuleNet's shape with the slice's route weights, per
    dtype: kernel, plain version, bound, kernels per call."""
    g = torch.Generator(device="cuda").manual_seed(8)
    x = torch.randn((CAPS_BATCH, 1296, 8), generator=g, device="cuda")
    cot = torch.randn((CAPS_BATCH, 43, 16), generator=g, device="cuda")
    out = {}
    for bf16 in (False, True):
        io = torch.bfloat16 if bf16 else torch.float32
        xi, wi = x.to(io), w_model.to(io)
        _, s = routing.routing_states_plain(x, w_model, 3, bf16)
        t = {"ms": time_ms(lambda: routing.routed_capsules_backward(
                 xi, wi, s, cot, 3, bf16)),
             "cold_ms": time_ms(lambda: routing.routed_capsules_backward(
                 xi, wi, s, cot, 3, bf16), cold=True),
             "plain_ms": time_ms(
                 lambda: routing.routed_capsules_backward_plain(
                     x, w_model, s, cot, 3, bf16), iters=5)}
        t["bound_ms"], t["bound_by"], nb, products, passes = \
            routing_bwd_bound(CAPS_BATCH, 1296, 43, bf16)
        t["kernels"] = count_kernels(lambda: routing.routed_capsules_backward(
            xi, wi, s, cot, 3, bf16))
        print(f"[time] routing_bwd x {tuple(x.shape)} w "
              f"{tuple(w_model.shape)} {'bf16' if bf16 else 'f32'}: kernel "
              f"{t['ms']:.4f} ms ({t['kernels']} CUDA kernels per call), "
              f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}: {nb} bytes, "
              f"votes+dx+dW {products} + routing {passes} FLOP), plain "
              f"(routed_capsules_backward_plain) {t['plain_ms']:.4f} ms; L2 "
              f"flushed before each call {t['cold_ms']:.4f} ms")
        launch_breakdown(lambda: routing.routed_capsules_backward(
            xi, wi, s, cot, 3, bf16), f"routing_bwd {'bf16' if bf16 else 'f32'}")
        out[bf16] = t
    return out


def time_train_step(params, crops, labels):
    """The train step at batch 64 on device-resident crops: CUDA-event
    time per step, then the profile of the same calls."""
    cfg = losses.LossConfig.from_params(params)
    x = torch.from_numpy(crops[:CAPS_BATCH]).cuda()
    y = torch.from_numpy(labels[:CAPS_BATCH]).cuda()
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        model = CapsuleNet(43, dtype=dtype, seed=0).cuda().train()
        opt = steps.make_optimizer(model)

        def step():
            return steps.train_step(model, opt, x, y, 1e-3, cfg, "capsule")

        ms = time_ms(step, iters=10)
        print(f"[time] capsule train step (forward with recon, loss, "
              f"backward, Adam) batch {CAPS_BATCH} {str(dtype)[6:]}: "
              f"{ms:.3f} ms = {CAPS_BATCH / ms * 1e3:.1f} img/s")
        profile_ms(step, ms)
        out[dtype] = ms
    return out


def write_darknet19_npz(path, seed=7):
    """A pretrained-weights npz in the darknet19 layout (layers 1-18:
    '{i}-scope/kernel:0' HWIO kernels, biases, gamma, moving_mean,
    moving_variance) from a seed; returns its arrays."""
    rng = np.random.RandomState(seed)
    arrs, in_c = {}, 3
    for i, (out_c, k, _) in enumerate(DARKNET_LAYERS):
        arrs[f"{i}-scope/kernel:0"] = (
            (2.0 / (k * k * in_c)) ** 0.5
            * rng.randn(k, k, in_c, out_c)).astype(np.float32)
        arrs[f"{i}-scope/biases:0"] = 0.1 * rng.randn(out_c).astype(
            np.float32)
        arrs[f"{i}-scope/gamma:0"] = (1 + 0.1 * rng.randn(out_c)).astype(
            np.float32)
        arrs[f"{i}-scope/moving_mean:0"] = 0.1 * rng.randn(out_c).astype(
            np.float32)
        arrs[f"{i}-scope/moving_variance:0"] = (0.5 + rng.rand(out_c)).astype(
            np.float32)
        in_c = out_c
    np.savez(path, **arrs)
    return arrs


def dark_train_params(dtype, **over):
    """darknet_r as in experiments/darknet_r/params.json, for 2 epochs at
    lr 1e-3 (the CLI default), as the CLI's train mode sets it."""
    p = Params(os.path.join(HERE, "experiments", "darknet_r", "params.json"),
               model="darknet_r", n_epochs=TRAIN_EPOCHS, lr_runtime=1e-3,
               eval_every=1, train_frac=1, summary=False,
               compute_dtype=dtype)
    p.__dict__.update(over)
    require((p.batch_size, p.dropout, p.lr_decay, p.darknet_input)
            == (BATCH, 0.5, 0.5, 448), "darknet_r training config")
    return p


def dark_train(params, model_dir, seed=0, is_small=False):
    """train_and_evaluate on the synthetic scenes (the overfit mode's 3/3
    with ``is_small``); returns the train losses, the launch counts of
    the run and its printout (echoed)."""
    os.makedirs(model_dir, exist_ok=True)
    np.random.seed(seed)
    reset_launches()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        driver.train_and_evaluate(params, os.path.join(model_dir, "nodata"),
                                  model_dir, is_small=is_small, seed=seed,
                                  device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    text = buf.getvalue()
    print(text, end="")
    losses_tr = np.load(os.path.join(model_dir, "losses_tr.npy"))
    scenes = ((3, 3) if is_small
              else (DARK_TRAIN_SCENES, DARK_EVAL_SCENES))
    print(f"[dark_train] {params.model} {params.compute_dtype}: "
          f"train_and_evaluate, {params.n_epochs} epochs of {scenes[0]} + "
          f"{scenes[1]} scenes, seed {seed}, in {wall:.3f} s (host "
          f"clock, init, data and checkpoints included); launches "
          f"{launches}; train losses {losses_tr.tolist()}")
    require(sum(launches.values()) == 0,
            f"a kernel launched during training: {launches}")
    require(np.isfinite(losses_tr).all(), "train loss not finite")
    return losses_tr, launches, text


def check_dark_grads(params, x, y):
    """Phases 13 and 19, on one batch: after a step every gradient is
    finite and non-zero and every parameter finite."""
    cfg = losses.LossConfig.from_params(params)
    model = DarkNet(n_boxes=int(params.n_boxes),
                    n_classes=int(params.n_classes),
                    dropout=float(params.dropout),
                    dtype=getattr(torch, params.compute_dtype),
                    seed=0).cuda().train()
    opt = steps.make_optimizer(model)
    gen = torch.Generator(device="cuda").manual_seed(0)
    loss, _, aux = steps.train_step(model, opt, x, y, 1e-3, cfg, params.model,
                                    gen)
    for name, p in model.named_parameters():
        require(torch.isfinite(p.grad).all() and p.grad.abs().max() > 0,
                f"{params.compute_dtype}: gradient of {name} not finite or "
                "all zero")
        require(torch.isfinite(p).all(), f"{name} not finite after a step")
    print(f"[dark_train] {params.model} {params.compute_dtype} one step on "
          f"a batch of "
          f"{BATCH}: loss {loss.item()}, avg_iou {aux['avg_iou'].item()}; "
          f"all {len(list(model.parameters()))} gradients finite and "
          "non-zero")


def run_dark_train_slice(frames, y_true, x_np, y_np, root):
    """Phase 13, with one batch (x_np, y_np) of training scenes for the
    gradient check; returns the f32 predict leg's launch counts.  Each
    run's directory (checkpoints of about 0.6 GB) goes once checked."""
    out = {}
    for dtype in ("float32", "bfloat16"):
        params = dark_train_params(dtype)
        model_dir = os.path.join(root, dtype)
        losses_tr = dark_train(params, model_dir)[0]
        require(losses_tr[-1] < losses_tr[0],
                f"{dtype}: the train loss did not fall: {losses_tr}")
        check_dark_grads(params, torch.from_numpy(x_np).cuda().to(
            getattr(torch, dtype)), torch.from_numpy(y_np).cuda())
        # serve the trained checkpoint: phase 5's checks and bands
        print(f"[dark_train] {dtype}-trained last.ckpt through dark_pred:")
        out[dtype] = run_slice(frames, y_true, model_dir,
                               dark_train_params("float32"))
        shutil.rmtree(model_dir + "1")

    # the dropout generator: one seed, one loss, to the bit
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    first = []
    for i, seed in enumerate((0, 0, 1)):
        model_dir = os.path.join(root, f"seed{seed}_{i}")
        first.append(float(dark_train(dark_train_params(
            "float32", n_epochs=1), model_dir, seed)[0][0]))
        shutil.rmtree(model_dir + "1")
    torch.backends.cudnn.deterministic = deterministic
    require(first[0] == first[1] != first[2],
            f"first-epoch losses for seeds 0, 0, 1: {first}")
    print(f"[dark_train] first-epoch loss, seeds 0, 0, 1 (cuDNN "
          f"deterministic): {first}: equal to the bit for one seed")

    # fine-tuning from a pretrained npz, blocks 1-18 frozen
    npz = os.path.join(root, "darknet19_weights.npz")
    arrs = write_darknet19_npz(npz)
    params = dark_train_params("float32", n_epochs=1, do_fine_tune=True,
                               fine_tune=18, pretrained_weights=npz)
    model_dir = os.path.join(root, "fine_tune")
    dark_train(params, model_dir)
    check_fine_tune(ckpt.load_checkpoint(os.path.join(
        model_dir + "1", "last.ckpt"))["state_dict"], arrs,
        DarkNet(n_boxes=1, n_classes=43, seed=0).model.conv_19.weight)
    shutil.rmtree(model_dir + "1")
    print("[dark_train] fine-tune from the npz, fine_tune 18: blocks 1-18 "
          "equal to the npz to the bit, conv_19 moved, bn_1.running_mean "
          "moved")
    return out["float32"]


def darknet_train_flop(size=448, n_out=5 + 43):
    """FLOP of one image's forward and train step, the head with ``n_out``
    channels: every conv forward and wgrad, every conv's dgrad but
    conv_1's (the input takes no gradient)."""
    fwd, hw, in_c = [], size, 3
    for out_c, k, after in DARKNET_LAYERS:
        fwd.append(2 * hw * hw * in_c * out_c * k * k)
        in_c = out_c
        if after == "mp":
            hw //= 2
    fwd.append(2 * hw * hw * in_c * n_out)
    return sum(fwd), 3 * sum(fwd) - fwd[0]


def time_dark_train_step(params, x_np, y_np):
    """Phases 14 and 19: the train step of the detector of ``params``
    (darknet_r, darknet_d) at batch 32, f32 and bf16: CUDA-event time per
    step beside its operation bound, then the profile of the same calls;
    returns {dtype: ms}."""
    name, nb, nc = params.model, int(params.n_boxes), int(params.n_classes)
    fwd, step_flop = darknet_train_flop(n_out=5 * nb + nc)
    print(f"[time] {name} at 448 px: {fwd / 1e9:.2f} GFLOP per image "
          f"forward, {step_flop * BATCH / 1e12:.3f} TFLOP per train step of "
          f"{BATCH}")
    cfg = losses.LossConfig.from_params(params)
    y = torch.from_numpy(y_np[:BATCH]).cuda()
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        model = DarkNet(n_boxes=nb, n_classes=nc,
                        dropout=float(params.dropout), dtype=dtype,
                        seed=0).cuda().train()
        opt = steps.make_optimizer(model)
        gen = torch.Generator(device="cuda").manual_seed(0)
        x = torch.from_numpy(x_np[:BATCH]).cuda().to(dtype)

        def step():
            return steps.train_step(model, opt, x, y, 1e-3, cfg, name, gen)

        torch.cuda.reset_peak_memory_stats()
        ms = time_ms(step, iters=10)
        bound, by = bound_ms(0, step_flop * BATCH, dtype)
        print(f"[time] {name} train step (forward with dropout "
              f"{params.dropout}, dark_loss, backward, Adam) batch {BATCH} "
              f"{str(dtype)[6:]}: {ms:.3f} ms = {BATCH / ms * 1e3:.1f} "
              f"img/s; bound {bound:.3f} ms ({by}), {bound / ms:.3f} of it; "
              f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
              f"GiB ({SMI})")
        profile_ms(step, ms, iters=3, groups=DARK_GROUPS, top=15)
        out[dtype] = ms
    return out


def darknet_d_params(dtype, **over):
    """darknet_d as in experiments/darknet_d/params.json (448 px, B=2,
    C=0, batch 32, no dropout, fine_tune 18), for 2 epochs at lr 1e-3
    (the CLI default), as the CLI's train mode sets it."""
    p = Params(os.path.join(HERE, "experiments", "darknet_d", "params.json"),
               model="darknet_d", n_epochs=TRAIN_EPOCHS, lr_runtime=1e-3,
               eval_every=1, train_frac=1, summary=False,
               compute_dtype=dtype)
    p.__dict__.update(over)
    require((p.batch_size, p.n_boxes, p.n_classes, p.n_grid,
             p.darknet_input, p.dropout, p.fine_tune)
            == (BATCH, 2, 0, 14, 448, 0.0, 18), "darknet_d config")
    return p


def run_darknet_d_serving(root):
    """Phase 18: a seeded full-width darknet_d (B=2, C=0, BN statistics
    from the scenes) through dark_pred, f32 and bf16 (phase 5's checks
    and bands), then its serving time and profile.  Returns the scenes,
    their grids, the checkpoint's dir and each run's launch counts."""
    params = darknet_d_params("float32")
    _, _, x, y_true = loader.synthetic_dataset("darknet_d", params, 0, 64)
    frames = np.clip(x * 128.0 + 128, 0, 255).astype(np.uint8)
    model_dir = os.path.join(root, "serve")
    ckpt.save_checkpoint(
        {"epoch": 0, "optim_dict": {},
         "state_dict": seeded_darknet(frames, n_boxes=2,
                                      n_classes=0).state_dict()},
        False, model_dir)
    runs = run_slice(frames, y_true, model_dir, params)
    time_serving(predict.restore_darknet(params, model_dir, "last").cuda(),
                 frames, "darknet_d")
    return frames, y_true, model_dir, runs


def check_fine_tune(sd, arrs, head):
    """The fine-tune epoch's checkpoint: blocks 1-18 equal to the npz to
    the bit, the head moved from ``head``, bn_1's running mean moved."""
    for i in range(1, 19):
        for key, name in ((f"conv_{i}.weight", "kernel:0"),
                          (f"bn_{i}.weight", "gamma:0"),
                          (f"bn_{i}.bias", "biases:0")):
            want = arrs[f"{i - 1}-scope/{name}"]
            if want.ndim == 4:
                want = want.transpose(3, 2, 0, 1)
            require(np.array_equal(sd["model." + key].numpy(), want),
                    f"fine-tune: frozen {key} moved")
    require(not torch.equal(sd["model.conv_19.weight"], head.detach()),
            "fine-tune: the head did not move")
    require(not np.array_equal(sd["model.bn_1.running_mean"].numpy(),
                               arrs["0-scope/moving_mean:0"]),
            "fine-tune: bn_1's running mean did not move")


def run_darknet_d_train(frames, y_true, root):
    """Phase 19: darknet_d through train_and_evaluate, f32 then bf16 (the
    loss falls, no kernel launches, the avg iou lines, finite non-zero
    gradients), each trained last.ckpt served through phase 5's checks;
    --mode overfit; a fine-tune epoch from an npz; the step's time.
    Returns the f32 predict leg's launch counts."""
    x_np, y_np, _, _ = loader.synthetic_dataset(
        "darknet_d", darknet_d_params("float32"), BATCH, 0)
    require(y_np.shape == (BATCH, 14, 14, 5), "darknet_d grids")
    out = {}
    for dtype in ("float32", "bfloat16"):
        params = darknet_d_params(dtype)
        model_dir = os.path.join(root, dtype)
        losses_tr, _, text = dark_train(params, model_dir)
        require(losses_tr[-1] < losses_tr[0],
                f"darknet_d {dtype}: the train loss did not fall: "
                f"{losses_tr}")
        for tag in ("train", "test"):
            require(text.count(f"{tag} avg iou: ")
                    == TRAIN_EPOCHS, f"darknet_d: the {tag} avg iou line")
        check_dark_grads(params, torch.from_numpy(x_np).cuda().to(
            getattr(torch, dtype)), torch.from_numpy(y_np).cuda())
        print(f"[dark_train] darknet_d {dtype}-trained last.ckpt through "
              "dark_pred:")
        out[dtype] = run_slice(frames, y_true, model_dir,
                               darknet_d_params("float32"))
        shutil.rmtree(model_dir + "1")

    # the CLI's --mode overfit: 3/3 scenes
    model_dir = os.path.join(root, "overfit")
    losses_tr = dark_train(darknet_d_params("float32"), model_dir,
                           is_small=True)[0]
    require(losses_tr[-1] < losses_tr[0],
            f"darknet_d overfit: the train loss did not fall: {losses_tr}")
    shutil.rmtree(model_dir + "1")

    # --fine_tune: the npz, blocks 1-18 (params.json's fine_tune) frozen
    npz = os.path.join(root, "darknet19_weights.npz")
    arrs = write_darknet19_npz(npz)
    model_dir = os.path.join(root, "fine_tune")
    text = dark_train(darknet_d_params("float32", n_epochs=1,
                                       do_fine_tune=True,
                                       pretrained_weights=npz), model_dir)[2]
    require(f"Load weights from {npz}" in text, "npz not loaded")
    check_fine_tune(ckpt.load_checkpoint(os.path.join(
        model_dir + "1", "last.ckpt"))["state_dict"], arrs,
        DarkNet(n_boxes=2, n_classes=0, seed=0).model.conv_19.weight)
    shutil.rmtree(model_dir + "1")
    print("[dark_train] darknet_d fine-tune from the npz, fine_tune 18: "
          "blocks 1-18 equal to the npz to the bit, conv_19 moved, "
          "bn_1.running_mean moved")

    time_dark_train_step(darknet_d_params("float32"), x_np, y_np)

    return out["float32"]


def run_darknet_d_combine(frames, y_true, dark_dir, classifiers):
    """Phase 19: --combine on phase 18's seeded darknet_d, as the CLI
    calls it (f32): cnn and capsule on the host path, capsule fused
    (--device_crop).  K2 x1 and K1 x4 per detector batch, K3 per 64 crops
    (host) or per detector batch (fused), and the JAX package's nan / 0.0
    combine metrics.  Returns each run's launch counts."""
    out = {}
    n_batches = -(-len(frames) // BATCH)
    for name, device_crop in (("cnn", False), ("capsule", False),
                              ("capsule", True)):
        dparams = darknet_d_params("float32")
        cparams = two_stage_params(name, "float32")[1]
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y_hat, (idx, _, _) = predict.dark_class_detect(
            list(frames), dark_dir, dparams, classifiers[name], cparams,
            "last", device="cuda", device_crop=device_crop,
            max_crops=MAX_CROPS)
        wall = time.perf_counter() - t0
        launches = read_launches()
        path = "fused" if device_crop else "host"
        n_k3 = 0
        if name == "capsule":
            n_k3 = n_batches if device_crop else -(-len(idx) // CAPS_BATCH)
        require(launches == two_stage_launches(len(frames), n_k3),
                f"darknet_d --combine {name} {path}: launches {launches}")
        require(len(idx) > 0 and np.isfinite(y_hat).all()
                and y_hat.shape == (len(frames), 14, 14, 10 + 43),
                f"darknet_d --combine {name} {path}: the combined grid")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)  # mean of none
            m_ap = det.detect_and_recog_mAP(y_true, y_hat, dparams)
        acc = det.detect_and_recog_acc(y_true, y_hat, dparams)
        print(f"[darknet_d] --combine {name} ({path} path): {len(frames)} "
              f"frames, {len(idx)} crops, {wall:.3f} s = "
              f"{len(frames) / wall:.1f} frames/s (host clock, restores "
              f"included; {SMI}); launches {launches}; "
              f"detect_and_recog_mAP:{m_ap}, detect_and_recog_acc:{acc}, "
              "(the JAX package's nan / 0.0: n_classes set to 43 leaves "
              "the 5-channel ground truth without a box)")
        require(np.isnan(m_ap) and acc == 0.0,
                "darknet_d --combine: not the JAX package's nan / 0.0")
        out[name, path] = launches
    return out


def darkcapsule_params(dtype, **over):
    """darkcapsule as in experiments/darkcapsule/params.json (n_grid 7,
    so 224 px; batch 32; its "device" key is not read), 2 epochs at lr
    1e-3, as the CLI's train mode sets it."""
    p = Params(os.path.join(HERE, "experiments", "darkcapsule",
                            "params.json"),
               model="darkcapsule", n_epochs=TRAIN_EPOCHS, lr_runtime=1e-3,
               eval_every=1, train_frac=1, summary=False,
               compute_dtype=dtype)
    p.__dict__.update(over)
    require((p.batch_size, p.n_grid) == (BATCH, 7), "darkcapsule config")
    return p


def darkcapsule_flop(size=224, n_grid=7):
    """FLOP of one image's DarkCapsuleNet forward and train step: the five
    convs (forward, wgrad, dgrad but conv_1's) and the routing's one
    contraction per cell (the K=1 closed form)."""
    fwd, hw, in_c = [], size, 3
    for out_c, k, stride in DARKCAPSULE_LAYERS:
        hw = (hw + 2 - k) // stride + 1
        fwd.append(2 * hw * hw * in_c * out_c * k * k)
        in_c = out_c
    fwd.append(2 * n_grid * n_grid * 512 * 8 * 5)
    return sum(fwd), 3 * sum(fwd) - fwd[0]


def check_darkcapsule_grads(params, x, y):
    """Phase 20, on one batch: after a step the route weights and every
    conv weight have a finite non-zero gradient, the conv biases (before
    a train-mode BN, so 0 but for rounding) one within a share of their
    weight's, the decoder none (never called); every parameter finite."""
    cfg = losses.LossConfig.from_params(params)
    model = DarkCapsuleNet(n_grid=7, dtype=getattr(torch,
                                                  params.compute_dtype),
                           seed=0).cuda().train()
    opt = steps.make_optimizer(model)
    loss, _, _ = steps.train_step(model, opt, x, y, 1e-3, cfg, "darkcapsule")
    named = dict(model.named_parameters())
    noise = 1e-3 if params.compute_dtype == "float32" else 5e-2
    for name, p in named.items():
        g = p.grad
        if name.startswith("decoder."):
            require(g is None, f"{name} has a gradient")
            continue
        require(torch.isfinite(g).all(), f"gradient of {name} not finite")
        if name.startswith("conv.conv") and name.endswith(".bias"):
            w = named[name[:-4] + "weight"].grad.abs().max().item()
            require(g.abs().max().item() <= noise * w,
                    f"{name}: gradient {g.abs().max().item()} beside its "
                    f"weight's {w}")
        else:
            require(g.abs().max() > 0, f"gradient of {name} all zero")
        require(torch.isfinite(p).all(), f"{name} not finite after a step")
    print(f"[darkcapsule] {params.compute_dtype} one step on a batch of "
          f"{BATCH}: loss {loss.item()}; the route weights' and all 5 conv "
          "weights' gradients finite and non-zero, the conv biases' "
          f"rounding noise within {noise} of their weights'")


def run_darkcapsule(root):
    """Phase 20: darkcapsule through train_and_evaluate at 224 px, batch
    32, f32 then bf16 (no kernel launches: its K=1 routing is the closed
    form; the loss falls; gradients), the step's time beside its bound
    and the forward's img/s; the trained model's forward on the card
    against the same model on the CPU (f32, atol 1e-4); the CLI's
    predict writes its empty metric file."""
    x_np, y_np, _, _ = loader.synthetic_dataset(
        "darkcapsule", darkcapsule_params("float32"), BATCH, 0)
    require(x_np.shape == (BATCH, 224, 224, 3)
            and y_np.shape == (BATCH, 7, 7, 48), "darkcapsule scenes")
    fwd, step_flop = darkcapsule_flop()
    print(f"[time] darkcapsule at 224 px: {fwd / 1e9:.2f} GFLOP per image "
          f"forward, {step_flop * BATCH / 1e12:.3f} TFLOP per train step of "
          f"{BATCH}")
    cfg = losses.LossConfig.from_params(darkcapsule_params("float32"))
    yd = torch.from_numpy(y_np).cuda()
    for dtype in ("float32", "bfloat16"):
        params = darkcapsule_params(dtype)
        model_dir = os.path.join(root, dtype)
        losses_tr = dark_train(params, model_dir)[0]
        require(losses_tr[-1] < losses_tr[0],
                f"darkcapsule {dtype}: the train loss did not fall: "
                f"{losses_tr}")
        dt = getattr(torch, dtype)
        xd = torch.from_numpy(x_np).cuda().to(dt)
        check_darkcapsule_grads(params, xd, yd)
        model = DarkCapsuleNet(n_grid=7, dtype=dt, seed=0).cuda().train()
        opt = steps.make_optimizer(model)

        def step():
            return steps.train_step(model, opt, xd, yd, 1e-3, cfg,
                                    "darkcapsule")

        torch.cuda.reset_peak_memory_stats()
        ms = time_ms(step, iters=10)
        bound, by = bound_ms(0, step_flop * BATCH, dt)
        print(f"[time] darkcapsule train step (forward, darkcapsule_loss, "
              f"backward, Adam) batch {BATCH} {dtype}: {ms:.3f} ms = "
              f"{BATCH / ms * 1e3:.1f} img/s; bound {bound:.3f} ms ({by}), "
              f"{bound / ms:.3f} of it; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({SMI})")
        profile_ms(step, ms, iters=3, groups=DARK_GROUPS, top=12)
        model.eval()
        with torch.inference_mode():
            ms_f = time_ms(lambda: model(xd), iters=10)
        bound_f, by_f = bound_ms(0, fwd * BATCH, dt)
        print(f"[time] darkcapsule eval forward batch {BATCH} {dtype}: "
              f"{ms_f:.3f} ms = {BATCH / ms_f * 1e3:.1f} img/s; bound "
              f"{bound_f:.3f} ms ({by_f}), {bound_f / ms_f:.3f} of it "
              f"({SMI})")
        if dtype == "float32":
            # the trained model on the card and on the CPU, f32
            sd = ckpt.load_checkpoint(os.path.join(
                model_dir + "1", "last.ckpt"))["state_dict"]
            net = DarkCapsuleNet(n_grid=7, seed=0)
            net.load_state_dict(sd, strict=True)
            x4 = torch.from_numpy(x_np[:4])
            with torch.no_grad():
                want = net.eval()(x4)
                got = net.cuda()(x4.cuda()).cpu()
            err = (got - want).abs().max().item()
            print(f"[darkcapsule] f32-trained model, 4 scenes: the card's "
                  f"forward vs the CPU's max_abs_err {err} (capsule "
                  f"lengths {want.norm(dim=-1).min().item():.3f}-"
                  f"{want.norm(dim=-1).max().item():.3f})")
            torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
        shutil.rmtree(model_dir + "1")

    # the CLI's predict: no predict function, an empty metric file
    cli_dir = os.path.join(root, "cli")
    os.makedirs(cli_dir, exist_ok=True)
    darkcapsule_params("float32").save(os.path.join(cli_dir, "params.json"))
    reset_launches()
    cli.main(["--model", "darkcapsule", "--mode", "predict", "--restore",
              "last", "--model_dir", cli_dir])
    launches = read_launches()
    with open(os.path.join(cli_dir, "metric_output.txt")) as f:
        text = f.read()
    require(text == "" and sum(launches.values()) == 0,
            f"darkcapsule predict: {text!r}, launches {launches}")
    print("[darkcapsule] the CLI's predict (--device cuda by default; the "
          "params' \"device\": \"cpu\" unread) wrote an empty "
          f"metric_output.txt; launches {launches}")


def cnn_params(dtype):
    """The cnn classifier as in experiments/cnn/params.json (32 px, 43
    classes, batch 64, dropout 0.5), 2 epochs at lr 1e-3, as the CLI's
    train mode sets it."""
    p = Params(os.path.join(HERE, "experiments", "cnn", "params.json"),
               model="cnn", n_epochs=TRAIN_EPOCHS, lr_runtime=1e-3,
               eval_every=1, train_frac=1, summary=False, compute_dtype=dtype)
    require((p.batch_size, p.n_classes, p.dropout) == (CAPS_BATCH, 43, 0.5),
            "cnn config")
    return p


def check_cnn_grads(params, x, y):
    """Phase 15, on one batch: after a step every gradient is finite and
    non-zero (but the two conv biases in front of a train-mode BN, whose
    gradient is 0 but for rounding), every parameter finite."""
    cfg = losses.LossConfig.from_params(params)
    model = ConvNet(43, dropout=0.5,
                    dtype=getattr(torch, params.compute_dtype),
                    seed=0).cuda().train()
    opt = steps.make_optimizer(model)
    gen = torch.Generator(device="cuda").manual_seed(0)
    loss, _, _ = steps.train_step(model, opt, x, y, 1e-3, cfg, "cnn", gen)
    named = dict(model.named_parameters())
    # the biases' noise, a share of their weight's largest gradient: f32
    # rounding, or bf16 rounding of the BN backward's output
    noise = 1e-3 if params.compute_dtype == "float32" else 5e-2
    for name, p in named.items():
        g = p.grad
        require(torch.isfinite(g).all(), f"gradient of {name} not finite")
        if name in ("cnn.0.bias", "cnn.4.bias"):
            w = named[name[:-4] + "weight"].grad.abs().max().item()
            require(g.abs().max().item() <= noise * w,
                    f"{name}: gradient {g.abs().max().item()} beside its "
                    f"weight's {w}")
        else:
            require(g.abs().max() > 0, f"gradient of {name} all zero")
        require(torch.isfinite(p).all(), f"{name} not finite after a step")
    print(f"[cnn_train] {params.compute_dtype} one step on a batch of "
          f"{CAPS_BATCH}: loss {loss.item()}; all {len(named)} gradients "
          "finite, non-zero but the two conv biases before BN (rounding "
          f"noise, at most {noise} of their weights')")


def run_cnn_train_slice(root):
    """Phase 15: the cnn classifier through train_and_evaluate, f32 then
    bf16; the step's time.  Returns the f32 run's checkpoint dir."""
    n_train = -(-TRAIN_CROPS // CAPS_BATCH)
    n_eval = -(-EVAL_CROPS // CAPS_BATCH)
    out = {}
    for dtype in ("float32", "bfloat16"):
        params = cnn_params(dtype)
        model_dir = os.path.join(root, dtype)
        os.makedirs(model_dir, exist_ok=True)
        np.random.seed(0)
        reset_launches()
        t0 = time.perf_counter()
        driver.train_and_evaluate(params, os.path.join(root, "nodata"),
                                  model_dir, seed=0, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        losses_tr = np.load(os.path.join(model_dir, "losses_tr.npy"))
        print(f"[cnn_train] {dtype}: train_and_evaluate, {TRAIN_EPOCHS} "
              f"epochs of {n_train} train + {n_eval} eval batches of "
              f"{CAPS_BATCH}, in {wall:.3f} s (host clock, init, data and "
              f"checkpoints included); launches {launches}; train losses "
              f"{losses_tr.tolist()}")
        require(sum(launches.values()) == 0,
                f"a kernel launched during cnn training: {launches}")
        require(np.isfinite(losses_tr).all() and losses_tr[-1] < losses_tr[0],
                f"{dtype}: the train loss did not fall: {losses_tr}")
        x, y, _, _ = loader.synthetic_dataset("cnn", params, CAPS_BATCH, 0)
        check_cnn_grads(params, torch.from_numpy(x).cuda().to(
            getattr(torch, dtype)), torch.from_numpy(y).cuda())
        y_hat, _ = predict.class_pred(x, model_dir, params, "last",
                                      device="cuda")
        require(y_hat.shape == (CAPS_BATCH, 43) and np.isfinite(y_hat).all(),
                f"{dtype}: scores from the trained last.ckpt")
        print(f"[cnn_train] {dtype}: class_pred restored last.ckpt from "
              f"{model_dir}{params.train_frac}: logits finite, "
              f"{y_hat.shape}, accuracy on the train batch "
              f"{float((y_hat.argmax(1) == y).mean())}")
        # the train step on device-resident crops
        model = ConvNet(43, dropout=0.5, dtype=getattr(torch, dtype),
                        seed=0).cuda().train()
        opt = steps.make_optimizer(model)
        gen = torch.Generator(device="cuda").manual_seed(0)
        cfg = losses.LossConfig.from_params(params)
        xd, yd = torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()
        ms = time_ms(lambda: steps.train_step(model, opt, xd, yd, 1e-3, cfg,
                                              "cnn", gen), iters=20)
        print(f"[time] cnn train step (forward with dropout, loss, backward,"
              f" Adam) batch {CAPS_BATCH} {dtype}: {ms:.3f} ms = "
              f"{CAPS_BATCH / ms * 1e3:.1f} img/s ({SMI})")
        profile_ms(lambda: steps.train_step(model, opt, xd, yd, 1e-3, cfg,
                                            "cnn", gen), ms, groups=CNN_GROUPS)
        out[dtype] = model_dir
    return out["float32"]


def two_stage_params(classifier, dtype):
    """darknet_r's and the classifier's params as the CLI's --combine
    loads them (experiments/*/params.json, the same --dtype)."""
    return (Params(os.path.join(HERE, "experiments", "darknet_r",
                                "params.json"), model="darknet_r",
                   batch_size=BATCH, compute_dtype=dtype),
            Params(os.path.join(HERE, "experiments", classifier,
                                "params.json"), model=classifier,
                   compute_dtype=dtype, train_frac=1))


def two_stage_launches(n_frames, n_k3):
    """What the two-stage paths launch: K2 once and K1 four times per
    detector batch, K3 ``n_k3`` times, K4 never."""
    n_batches = -(-n_frames // BATCH)
    return {"input_stage": n_batches, "pool_leaky": 4 * n_batches,
            "routing": n_k3, "routing_bwd": 0}


def run_two_stage_host(frames, dark_dir, classifiers):
    """Phase 16: dark_class_pred (the host composition) as the CLI calls
    it, capsule and cnn, f32 and bf16: launch counts, the combined grid
    against its parts run alone, frames/s and the time by stage."""
    frames = list(frames)
    out = {}
    for name, cdir in classifiers.items():
        for dtype in ("float32", "bfloat16"):
            dparams, cparams = two_stage_params(name, dtype)
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y_hat, (idx, bx, classes) = predict.dark_class_detect(
                frames, dark_dir, dparams, cdir, cparams, "last",
                device="cuda")
            wall = time.perf_counter() - t0
            launches = read_launches()
            n = len(idx)
            n_k3 = -(-n // CAPS_BATCH) if name == "capsule" else 0
            print(f"[two_stage] host {name} {dtype}: {len(frames)} frames, "
                  f"{n} crops, {wall:.3f} s = {len(frames) / wall:.1f} "
                  f"frames/s end to end (host clock, restores included; "
                  f"{SMI}); launches {launches}")
            require(n > 0, "no crops: the detector found nothing")
            require(launches == two_stage_launches(len(frames), n_k3),
                    f"two-stage {name} {dtype}: kernel launches {launches}")
            require(np.isfinite(y_hat).all() and y_hat.shape == (
                len(frames), 14, 14, 48 + 43), "combined grid")
            # the same stages alone, timed on the host clock
            times = {}
            t0 = time.perf_counter()
            dark_y, boxes = predict.dark_detect(frames, dark_dir, dparams,
                                                "last", device="cuda")
            times["detector"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            crops = crop.frame_crops(frames, boxes[0], boxes[1],
                                     int(dparams.capsule_input), "cuda")
            times["crops"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            scores, cls = predict.class_pred(loader.center_rgb(crops), cdir,
                                             cparams, "last", device="cuda")
            times["classifier"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            want = box_ops.combine_y_hat(frames, dark_y, scores, boxes[0],
                                         boxes[1], dparams)
            times["combine"] = time.perf_counter() - t0
            print(f"[two_stage] host {name} {dtype}: by stage (s, host "
                  f"clock, each with its restore) "
                  f"{ {k: round(v, 4) for k, v in times.items()} }")
            d_det = np.abs(y_hat[..., :48] - dark_y).max()
            d_cls = np.abs(y_hat[..., 48:] - want[..., 48:]).max()
            print(f"[two_stage] host {name} {dtype}: combined grid vs "
                  f"dark_pred's y_hat max_abs_diff {d_det}, class channels "
                  f"vs class_pred on the same crops {d_cls}")
            require(np.array_equal(idx, boxes[0])
                    and np.array_equal(bx, boxes[1])
                    and np.array_equal(classes, cls), "detections differ")
            require(d_det <= 1e-6 and d_cls <= 1e-6,
                    "combined grid differs from its parts")
            out[name, dtype] = launches
    return out


def check_routing_b512(w):
    """Phase 17: K3 at the fused path's batch (32 frames x 16 crops)
    against its plain version, shared memory NaN-filled first; its time
    beside its bound.  Returns {bf16: (max_abs_err, ms, bound_ms)}."""
    g = torch.Generator(device="cuda").manual_seed(8)
    b = BATCH * MAX_CROPS
    x = torch.randn((b, 1296, 8), generator=g, device="cuda")
    out = {}
    for bf16 in (False, True):
        io = torch.bfloat16 if bf16 else torch.float32
        xi, wi = x.to(io), w.to(io)
        _build.fill_shared_memory(float("nan"))
        got = routing.routed_capsules(xi, wi, 3, bf16=bf16)
        torch.cuda.synchronize()
        want = routing.routed_capsules_plain(x, w, 3, bf16=bf16)
        err = (got - want).abs().max().item()
        torch.testing.assert_close(got, want, **K3_TOL[bf16])
        ms = time_ms(lambda: routing.routed_capsules(xi, wi, 3, bf16))
        plain = time_ms(lambda: routing.routed_capsules_plain(x, w, 3, bf16),
                        iters=5)
        bound, by, *_ = routing_bound(b, 1296, 43, bf16)
        print(f"[K3] routing at B {b} {'bf16' if bf16 else 'f32'}: "
              f"max_abs_err {err} vs plain; plan "
              f"{routing.kernel_config(b, 1296, 43, 3, io)['k3']}; kernel "
              f"{ms:.4f} ms, bound {bound:.4f} ms ({by}), plain {plain:.4f} "
              f"ms ({SMI})")
        out[bf16] = (err, ms, bound)
    return out


def run_two_stage_fused(frames, dark_dir, classifiers):
    """Phase 17: dark_class_pred(device_crop=True) as the CLI calls it,
    f32 and bf16: launch counts and frames/s; then the same composition
    per batch with the plain routing, whose class scores must hold K3's
    bands."""
    frames = list(frames)
    out = {}
    for name, cdir in classifiers.items():
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            dparams, cparams = two_stage_params(name, dtype)
            n_batches = -(-len(frames) // BATCH)
            for _ in range(2):   # the second run is timed
                reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                y_hat, (idx, _, _) = predict.dark_class_detect(
                    frames, dark_dir, dparams, cdir, cparams, "last",
                    device="cuda", device_crop=True, max_crops=MAX_CROPS)
                wall = time.perf_counter() - t0
            launches = read_launches()
            print(f"[two_stage] fused {name} {dtype}: {len(frames)} frames, "
                  f"{len(idx)} crops classified, {wall:.3f} s = "
                  f"{len(frames) / wall:.1f} frames/s end to end (host "
                  f"clock, restores included; {SMI}); launches {launches}")
            require(len(idx) > 0 and np.isfinite(y_hat).all(), "fused grid")
            require(launches == two_stage_launches(
                len(frames), n_batches if name == "capsule" else 0),
                f"fused {name} {dtype}: kernel launches {launches}")
            det = predict.restore_darknet(dparams, dark_dir, "last").cuda()
            cls = predict.restore_classifier(cparams, cdir, "last").cuda()
            tail = dict(n_boxes=1, n_classes=43, img_size=448, cap_input=32,
                        max_crops=MAX_CROPS, conf_th=0.5)
            with torch.inference_mode():
                p = ist.prepare_serving(det.state_dict(), dt)

                def fused(xb, classify=cls):
                    yb = ist.darknet_serving_apply(p, xb, n_boxes=1,
                                                   n_classes=43, dtype=dt)
                    return export._two_stage_tail(
                        xb, yb, classify=classify, use_nms=False,
                        with_grid=False, **tail)

                # one detector batch on device-resident frames
                x0 = torch.from_numpy(np.stack(frames[:BATCH])).cuda().float()
                ms = time_ms(lambda: fused(x0), iters=10)
                print(f"[time] fused two-stage {name} {dtype}, one batch of "
                      f"{BATCH} frames (detector, decode, {BATCH * MAX_CROPS}"
                      f" crops, classifier): {ms:.3f} ms = "
                      f"{BATCH / ms * 1e3:.1f} frames/s ({SMI})")
                profile_ms(lambda: fused(x0), ms)
                if name != "capsule":
                    continue
                # the composition per batch, K3 against the plain routing
                worst = 0.0
                for i in range(0, len(frames), BATCH):
                    xb = torch.from_numpy(np.stack(frames[i:i + BATCH]))
                    xb = xb.cuda().float()
                    got = fused(xb)
                    want = fused(xb, lambda c: plain_scores(cls, c, dt))
                    require(torch.equal(got["valid"], want["valid"]),
                            "crops differ")
                    torch.testing.assert_close(got["class_scores"],
                                               want["class_scores"],
                                               **K3_TOL[dt == torch.bfloat16])
                    worst = max(worst, (got["class_scores"]
                                        - want["class_scores"]).abs().max()
                                .item())
            print(f"[two_stage] fused capsule {dtype}: class scores at B "
                  f"{BATCH * MAX_CROPS} vs the plain routing max_abs_err "
                  f"{worst} (K3's bands)")
            out[dtype] = launches
    return out


def write_ppm(path, bgr):
    """A binary PPM (P6) of a BGR frame, with a header comment."""
    h, w = bgr.shape[:2]
    with open(path, "wb") as f:
        f.write(b"P6\n# chip_smoke\n%d %d\n255\n" % (w, h)
                + np.ascontiguousarray(bgr[..., ::-1]).tobytes())


def png_rgb(path):
    """uint8 (H, W, 3) RGB of an 8-bit RGB PNG whose rows use filter 0
    (what the port writes), decoded here with zlib alone."""
    with open(path, "rb") as f:
        data = f.read()
    require(data[:8] == b"\x89PNG\r\n\x1a\n", f"{path}: not a PNG")
    pos, idat, head = 8, [], None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        require(zlib.crc32(kind + body) == struct.unpack(
            ">I", data[pos + 8 + n:pos + 12 + n])[0], f"{path}: bad CRC")
        if kind == b"IHDR":
            head = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        pos += 12 + n
    require(head is not None and head[2:] == (8, 2, 0, 0, 0),
            f"{path}: header {head}")
    w, h = head[:2]
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = rows.reshape(h, 1 + 3 * w)
    require(not rows[:, 0].any(), f"{path}: a row filter other than 0")
    return rows[:, 1:].reshape(h, w, 3)


def numpy_nms(xy, valid, iou_th=0.5):
    """Greedy NMS in numpy over a confidence-sorted list: a slot still
    kept suppresses each later slot whose IoU (f32, 0/0 as 0) with it
    exceeds ``iou_th``."""
    keep = valid.copy()
    n = xy.shape[1]
    for b in range(xy.shape[0]):
        for i in range(n):
            if not keep[b, i]:
                continue
            a, o = xy[b, i], xy[b, i + 1:]
            wh = np.clip(np.minimum(a[2:], o[:, 2:])
                         - np.maximum(a[:2], o[:, :2]), 0, None)
            inter = wh[:, 0] * wh[:, 1]
            union = ((a[2] - a[0]) * (a[3] - a[1])
                     + (o[:, 2] - o[:, 0]) * (o[:, 3] - o[:, 1]) - inter)
            with np.errstate(invalid="ignore", divide="ignore"):
                iou = np.nan_to_num(inter / union)
            keep[b, i + 1:] &= ~(iou > iou_th)
    return keep


def ckpt_file(model_dir):
    """The last.ckpt under ``model_dir`` or where training writes it."""
    for d in (model_dir, model_dir + "1"):
        if os.path.exists(os.path.join(d, "last.ckpt")):
            return os.path.join(d, "last.ckpt")
    raise RuntimeError(f"chip_smoke: no last.ckpt under {model_dir}")


def cli_in(root, argv):
    """The CLI's main from ``root`` (its relative data/ and experiments/
    paths); returns the launch counts of the run and its host time."""
    here = os.getcwd()
    os.chdir(root)
    try:
        reset_launches()
        t0 = time.perf_counter()
        cli.main(argv)
        torch.cuda.synchronize()
        return read_launches(), time.perf_counter() - t0
    finally:
        os.chdir(here)


def run_predict_outputs(frames, y_true, dark_dir, classifiers, root):
    """Phase 21: a GTSDB-style data dir (P6 frames, test_names.npy,
    test.p) through the CLI's predict with --nms, then --combine cnn and
    capsule fused; the frames read back, the launches, the kept boxes
    against a numpy NMS on the same decode, and every PNG decoded here.
    Returns the launch counts of each run."""
    frames = list(frames[:PPM_FRAMES])
    y = y_true[:PPM_FRAMES]
    gtsdb = os.path.join(root, "data", "GTSDB")
    os.makedirs(os.path.join(gtsdb, "raw_GTSDB"), exist_ok=True)
    names = [f"{i:05d}.ppm" for i in range(len(frames))]
    for name, f in zip(names, frames):
        write_ppm(os.path.join(gtsdb, "raw_GTSDB", name), f)
    np.save(os.path.join(gtsdb, "test_names.npy"), np.array(names))
    with open(os.path.join(gtsdb, "test.p"), "wb") as f:
        pickle.dump((np.zeros((len(frames), 1), np.float32), y), f)
    exp = os.path.join(root, "experiments")
    for name, src in (("darknet_r", dark_dir), ("cnn", classifiers["cnn"]),
                      ("capsule", classifiers["capsule"])):
        os.makedirs(os.path.join(exp, name), exist_ok=True)
        shutil.copy(os.path.join(HERE, "experiments", name, "params.json"),
                    os.path.join(exp, name, "params.json"))
        shutil.copy(ckpt_file(src), os.path.join(exp, name, "last.ckpt"))
    params = Params(os.path.join(exp, "darknet_r", "params.json"),
                    model="darknet_r")
    read, _ = cli.load_test_frames(gtsdb, "darknet_r", params)
    require(all(np.array_equal(a, b) for a, b in zip(read, frames))
            and len(read) == len(frames), "frames read back differ")
    print(f"[outputs] {len(frames)} P6 frames written and read back "
          "equal (no cv2)")

    out = {}
    launches, wall = cli_in(root, ["--model", "darknet_r", "--mode",
                                   "predict", "--restore", "last", "--nms"])
    print(f"[outputs] CLI predict --nms over {len(frames)} frames: "
          f"{wall:.3f} s (host clock, restore and artifacts included); "
          f"launches {launches}")
    require(launches == two_stage_launches(len(frames), 0),
            f"predict --nms: kernel launches {launches}")
    out["predict --nms"] = launches
    ddir = os.path.join(exp, "darknet_r")
    # the same frames in-process: the kept boxes against numpy's NMS
    y_hat, (idx, xy, cls) = predict.dark_detect(
        frames, ddir, params, "last", device="cuda", use_nms=True)
    d = decode.decode_grid(torch.from_numpy(y_hat).cuda(), n_classes=43,
                           n_boxes=1, img_size=448)
    keep = numpy_nms(d["xy"].cpu().numpy(), d["valid"].cpu().numpy())
    hw = np.array([f.shape[:2] for f in frames])
    want = decode.to_flat_host(dict(d, valid=torch.from_numpy(keep)),
                               image_hw=hw, img_size=448)
    require(np.array_equal(idx, want[0]) and np.array_equal(cls, want[2])
            and np.allclose(xy, want[1], rtol=0, atol=1e-3),
            "NMS kept other boxes than numpy's")
    n_valid = int(d["valid"].sum())
    print(f"[outputs] NMS kept {len(idx)} of {n_valid} boxes above 0.5, "
          "as a numpy greedy NMS on the same decode")
    require(0 < len(idx) < n_valid, "NMS suppressed nothing or everything")
    drawn, _ = viz.draw_boxes_vec(frames, idx, xy, cls)
    t_idx, t_xy, t_cls = box_ops.y_to_boxes_vec(y, params, image_hw=hw)
    drawn, _ = viz.draw_boxes_vec(drawn, t_idx, t_xy, t_cls,
                                  color=(0, 0, 255))
    n_corners = 0
    for i, want_bgr in enumerate(drawn):
        img = png_rgb(os.path.join(ddir, "output", f"{i}.png"))
        require(np.array_equal(img, want_bgr[..., ::-1]),
                f"output/{i}.png differs from the frame with its boxes")
        # each kept box's corners inside the frame: green, or red where
        # a ground-truth box was drawn over it
        for x1, y1, x2, y2 in xy[idx == i].astype(int):
            for cx, cy in ((x1, y1), (x2, y1), (x1, y2), (x2, y2)):
                if 0 <= cx < 448 and 0 <= cy < 448:
                    require(tuple(img[cy, cx]) in ((0, 255, 0), (255, 0, 0)),
                            f"output/{i}.png: no rectangle at a box corner")
                    n_corners += 1
    require(png_rgb(os.path.join(ddir, "detect_ap", "d_AP.png")).shape
            == (800, 1000, 3), "d_AP.png size")
    with open(os.path.join(ddir, "metric_output.txt")) as f:
        text = f.read()
    require(text.startswith("detect_AP:"), f"metric file {text!r}")
    print(f"[outputs] output/0..{len(drawn) - 1}.png decoded (zlib) equal "
          f"to the frames with the kept boxes and the ground truth drawn; "
          f"{n_corners} box corners green/red; detect_ap/d_AP.png "
          f"1000x800; {text}")

    for name in ("cnn", "capsule"):
        launches, wall = cli_in(root, [
            "--model", "darknet_r", "--mode", "predict", "--restore",
            "last", "--combine", name, "--device_crop"])
        print(f"[outputs] CLI --combine {name} --device_crop over "
              f"{len(frames)} frames: {wall:.3f} s (host clock); launches "
              f"{launches}")
        require(launches == two_stage_launches(
            len(frames), 1 if name == "capsule" else 0),
            f"--combine {name}: kernel launches {launches}")
        for c in (0, 42):
            require(png_rgb(os.path.join(
                ddir, f"combine-{name}_mAP", f"d&r_mAP_class_{c}.png"))
                .shape == (800, 1000, 3), "mAP plot size")
        for i in range(len(frames)):
            require(png_rgb(os.path.join(ddir, "output", f"{i}.png")).shape
                    == (448, 448, 3), f"--combine {name}: output/{i}.png")
        with open(os.path.join(
                ddir, f"combine-{name}_metric_output.txt")) as f:
            text = f.read()
        require(text.startswith("detect_and_recog_mAP:"), text)
        print(f"[outputs] --combine {name}: {text}; 43 mAP plots, "
              f"{len(frames)} annotated frames")
        out[f"--combine {name} --device_crop"] = launches
    return out


def jax_test_darknet(seed=0):
    """Full-width darknet_r built as JAX's int8 test builds its network
    (tests/test_quant.py:18-39): initial weights from the seed, each BN
    scale, bias, running mean and variance raised by 0.05 |N(0, 1)|."""
    model = DarkNet(1, 43, seed=seed)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, t in list(model.named_parameters()) + list(
                model.named_buffers()):
            if ".bn_" in name and t.is_floating_point():
                t.add_(0.05 * torch.randn(t.shape, generator=g).abs())
    return model.eval()


def int8_against_f32(frames, model_dir, params, label):
    """dark_detect under --dtype int8 and float32 over ``frames``: the
    int8 run's launches and its error against f32 (printed by channel
    group).  Returns (launches, y_hat int8, abs error)."""
    params.compute_dtype = "int8"
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y8, boxes = predict.dark_detect(frames, model_dir, params, "last",
                                    device="cuda")
    wall = time.perf_counter() - t0
    launches = read_launches()
    params.compute_dtype = "float32"
    y32, _ = predict.dark_detect(frames, model_dir, params, "last",
                                 device="cuda")
    err = np.abs(y8 - y32)
    by_group = {k: (float(v.mean()), float(v.max())) for k, v in (
        ("confidence", err[..., 0]), ("box", err[..., 1:5]),
        ("class", err[..., 5:]))}
    print(f"[int8] {label}: dark_detect --dtype int8 over {len(frames)} "
          f"scenes in {wall:.3f} s (host clock, restore, fold, "
          f"quantization and calibration included), {len(boxes[0])} boxes; "
          f"launches {launches}; y_hat vs f32 serving mean_abs_err "
          f"{err.mean()} max {err.max()}; (mean, max) by channel group "
          f"{by_group}")
    require(np.isfinite(y8).all(), f"{label}: int8 y_hat not finite")
    require(sum(launches.values()) == 0,
            f"{label}: int8 serving launched a kernel: {launches}")
    return launches, y8, err


def run_int8_serving(frames, model_dir, params, serving_ms, root):
    """Phase 22: darknet_r served under --dtype int8 through dark_detect
    over phase 5's scenes: no kernel launch; every layer's s32
    accumulators equal to an exact f64 convolution, layer 1's to a CPU
    product; JAX's int8 bands against f32 on a detector built as
    JAX's int8 test builds its own, and phase 5's detector's error with
    its growth by layer (a measurement: its frame-measured BN statistics
    leave activations with max/std 20-40, which the static per-tensor
    scales resolve coarsely, in the JAX package as here); the time beside
    phase 6's f32 and bf16, the profile and the peak memory.  Returns the
    launches and the ms per batch."""
    frames = list(frames)
    launches, _, err5 = int8_against_f32(frames, model_dir, params,
                                         "phase 5's detector")

    jdir = os.path.join(root, "jax_test_darknet")
    ckpt.save_checkpoint({"epoch": 0, "optim_dict": {},
                          "state_dict": jax_test_darknet().state_dict()},
                         False, jdir)
    _, _, err = int8_against_f32(frames, jdir, params,
                                 "the JAX int8 test's construction")

    def in_band(e):
        return e.mean() < INT8_BANDS[0] and e.max() < INT8_BANDS[1]

    print(f"[int8] bands (JAX tests/test_quant.py:64-65: mean < "
          f"{INT8_BANDS[0]}, max < {INT8_BANDS[1]}): JAX test's "
          f"construction mean {err.mean()} max {err.max()}; phase 5's "
          f"detector mean {err5.mean()} max {err5.max()} (in band: "
          f"{in_band(err5)})")
    require(in_band(err), "int8 y_hat outside JAX's bands")

    model = predict.restore_darknet(params, model_dir, "last").cuda()
    sd = model.state_dict()
    x = preprocess_images(frames[:BATCH], 448, "cuda")
    with torch.inference_mode():
        q = quant.quantize_darknet(sd, x_cal=x)
        y8 = quant.darknet_int8_resident_apply(q, x, n_boxes=1, n_classes=43)
        # layer by layer: the s32 accumulators against an exact f64
        # convolution of the same int8 operands (integers below 2^53),
        # and the int8 activation (the dequantized epilogue) against the
        # folded f32 forward, as a relative error
        layers, _ = quant.fold_darknet(sd)
        act, xf = q["act_scales"], x.float()
        z, rel = quant._requant(x, act[0]), []
        for i, ((_, k, after), L, Q) in enumerate(zip(
                DARKNET_LAYERS, layers, q["layers"])):
            acc = quant._int8_conv(z, Q["wq"], k)
            ref = F.conv2d(z.double().permute(0, 3, 1, 2),
                           Q["wq"].double().permute(3, 2, 0, 1),
                           padding=1 if k == 3 else 0).permute(0, 2, 3, 1)
            require(torch.equal(acc.double(), ref),
                    f"layer {i + 1}: the int8 product is not exact")
            xf = F.leaky_relu(quant._conv_f32(xf, L["w"], k) + L["b"], 0.1)
            a = quant._epilogue(acc, act[i], Q["ws"], Q["b"], 0.1)
            rel.append(round(((a - xf).norm() / xf.norm()).item(), 4))
            if i + 1 < len(DARKNET_LAYERS):
                z = quant._requant(a, act[i + 1])
                z = quant._max_pool_int8(z) if after == "mp" else z
            xf = quant._max_pool(xf) if after == "mp" else xf
        # the chain's output is this loop's through the f32 head (cuBLAS
        # may pick another algorithm for another alignment: 1e-6)
        torch.testing.assert_close(
            y8, quant._head_f32(a, q["head"], 1, 43), rtol=0, atol=1e-6)
        print(f"[int8] phase 5's detector, one batch: all 18 layers' s32 "
              f"accumulators equal an exact f64 convolution of the same "
              f"int8 operands; relative error of each layer's activation "
              f"against f32, layers 1-18: {rel}")
        z = quant._requant(x, q["act_scales"][0])
        acc = quant._int8_conv(z, q["layers"][0]["wq"], 3)
        torch.cuda.synchronize()
    cols = quant._im2col(z.cpu(), 3).double()
    rows = quant._weight_rows(q["layers"][0]["wq"].cpu()).double()
    want = (cols @ rows.t()).reshape(acc.shape)
    require(torch.equal(acc.cpu().double(), want),
            "layer 1's s32 accumulators differ from the CPU product")
    print(f"[int8] layer 1 on one batch: {acc.numel()} s32 accumulators "
          f"({tuple(acc.shape)}, reduction 27 padded to {cols.shape[1]}) "
          "equal to the CPU's f64 product of the same int8 operands")
    del cols, rows, want

    def fwd_decode():
        y = quant.darknet_int8_resident_apply(q, x, n_boxes=1, n_classes=43)
        return decode.decode_grid(y, n_classes=43, n_boxes=1, img_size=448)

    with torch.inference_mode():
        ms = time_ms(fwd_decode, iters=10)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fwd_decode()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        f32, bf16 = serving_ms[torch.float32], serving_ms[torch.bfloat16]
        print(f"[time] darknet_r serving forward+decode batch {BATCH} int8 "
              f"(im2col + _int_mm, f32 epilogues, int8 pools): {ms:.3f} ms "
              f"= {BATCH / ms * 1e3:.1f} img/s; phase 6 in this call: f32 "
              f"{f32:.3f} ms = {BATCH / f32 * 1e3:.1f} img/s, bf16 "
              f"{bf16:.3f} ms = {BATCH / bf16 * 1e3:.1f} img/s; peak memory "
              f"of a batch above its inputs {peak / 2 ** 30:.3f} GiB "
              f"({SMI})")
        profile_ms(fwd_decode, ms, groups=INT8_GROUPS)
    return launches, ms


def run_int8_two_stage(frames, dark_dir, classifiers):
    """Phase 23: the two-stage paths under --dtype int8: fused with the
    int8 ConvNet (no kernel launch), fused with CapsuleNet in f32 (K3
    once a detector batch at B 512), the host path with the ConvNet in
    f32; frames/s of each (the second of two runs)."""
    frames = list(frames)
    n_batches = -(-len(frames) // BATCH)
    out = {}
    for name, fused in (("cnn", True), ("capsule", True), ("cnn", False)):
        dparams, cparams = two_stage_params(name, "int8")
        for _ in range(2):
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y_hat, (idx, _, classes) = predict.dark_class_detect(
                frames, dark_dir, dparams, classifiers[name], cparams,
                "last", device="cuda", device_crop=fused,
                max_crops=MAX_CROPS)
            wall = time.perf_counter() - t0
        launches = read_launches()
        path = "fused" if fused else "host"
        n_k3 = n_batches if (name == "capsule" and fused) else 0
        print(f"[int8 two_stage] {path} {name}: {len(frames)} frames, "
              f"{len(idx)} crops, {wall:.3f} s = {len(frames) / wall:.1f} "
              f"frames/s end to end (host clock, restores and calibration "
              f"included; {SMI}); launches {launches}")
        require(len(idx) > 0 and np.isfinite(y_hat).all()
                and y_hat.shape == (len(frames), 14, 14, 91),
                f"int8 {path} {name}: combined grid")
        require(launches == {"input_stage": 0, "pool_leaky": 0,
                             "routing": n_k3, "routing_bwd": 0},
                f"int8 {path} {name}: kernel launches {launches}")
        out[f"{path} {name}"] = launches
    return out


def run_wgrad_precision(y_np):
    """Phase 24 (a measurement): one darknet_r train step at 448 px,
    batch 32, dropout 0, on noise frames, in f32 (cuDNN, TF32 off) and
    in f64 on the card from the same weights; each weight gradient's
    largest error over its max|g| and its cosine with the f64 one."""
    g = torch.Generator(device="cuda").manual_seed(9)
    x = torch.rand((BATCH, 448, 448, 3), generator=g, device="cuda") * 2 - 1
    y = torch.from_numpy(y_np[:BATCH]).cuda()
    cfg = losses.LossConfig.from_params(dark_train_params("float32"))
    grads = {}
    for dtype in (torch.float64, torch.float32):
        model = DarkNet(1, 43, dtype=dtype, seed=0)
        if dtype == torch.float64:
            model.double()
        model = model.cuda().train()
        opt = steps.make_optimizer(model)
        t0 = time.perf_counter()
        loss, _, _ = steps.train_step(model, opt, x.to(dtype), y, 1e-3, cfg,
                                      "darknet_r")
        torch.cuda.synchronize()
        print(f"[wgrad] darknet_r step {str(dtype)[6:]} at batch {BATCH}, "
              f"448 px: loss {loss.item()}, "
              f"{time.perf_counter() - t0:.3f} s (host clock, first call)")
        grads[dtype] = {n: p.grad.double().cpu()
                        for n, p in model.named_parameters()
                        if n.endswith("weight") and ".conv_" in n}
        del model, opt
        torch.cuda.empty_cache()
    rows = []
    for n, ref in grads[torch.float64].items():
        got = grads[torch.float32][n]
        share = ((got - ref).abs().max() / ref.abs().max()).item()
        cos = F.cosine_similarity(got.flatten(), ref.flatten(), 0).item()
        rows.append((n, share, cos))
        print(f"[wgrad]   {n:24s} error/max|g| {share:.3e}  cosine "
              f"{cos:.9f}")
    worst = max(rows, key=lambda r: r[1])
    c18 = [r for r in rows if "conv_18." in r[0]][0]
    print(f"[wgrad] f32 vs f64 weight gradients at batch {BATCH}, 448 px: "
          f"worst {worst[0]} {worst[1]:.3e}; conv_18 {c18[1]:.3e} (cosine "
          f"{c18[2]:.9f}); least cosine {min(r[2] for r in rows):.9f} "
          f"({SMI})")
    require(all(np.isfinite(r[1]) for r in rows), "a gradient not finite")
    return rows


def artifact_path(root, name):
    os.makedirs(root, exist_ok=True)
    return os.path.join(root, name + ".pt2")


def export_and_load(fn, shape, root, name):
    """``fn`` exported with a symbolic batch on the card, saved and loaded
    back; returns the loaded callable, the export's and the load's
    seconds and the artifact's MB."""
    t0 = time.perf_counter()
    blob = export.export_serving(fn, shape, device="cuda")
    path = export.save(blob, artifact_path(root, name))
    t1 = time.perf_counter()
    call = export.load_serving(path, device="cuda")
    return call, t1 - t0, time.perf_counter() - t1, len(blob) / 1e6


def kernel_nodes(call):
    """The artifact graph's cyt::* nodes, counted by operator."""
    nodes = export._kernel_nodes(call.exported)
    return {n.split(".")[1]: nodes.count(n) for n in sorted(set(nodes))}


def counted(fn, *args):
    """``fn(*args)`` with every launch count set to 0 just before it;
    returns its output and the counts read just after."""
    reset_launches()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, read_launches()


def in_turns(a, b, iters=10):
    """The CUDA-event ms per call of ``a`` and ``b``, timed in turns (a, b,
    b, a) in this call; returns the two means."""
    ta, tb = [], []
    for first, second, to_first, to_second in ((a, b, ta, tb),
                                              (b, a, tb, ta)):
        to_first.append(time_ms(first, iters=iters))
        to_second.append(time_ms(second, iters=iters))
    return sum(ta) / 2, sum(tb) / 2


def by_candidate(d, n_cand):
    """A decode dict's per-slot confidences and corners put back at their
    candidate index: (B, n_cand) and (B, n_cand, 4), NaN where no slot."""
    b = d["conf"].shape[0]
    conf = torch.full((b, n_cand), float("nan"), device=d["conf"].device)
    xy = torch.full((b, n_cand, 4), float("nan"), device=d["conf"].device)
    idx = d["idx"].long()
    conf.scatter_(1, idx, d["conf"].float())
    xy.scatter_(1, idx[..., None].expand(-1, -1, 4), d["xy"].float())
    return conf, xy


def run_detector_artifacts(frames, model_dir, params, root):
    """Phase 25: darknet_r @448 (phase 5's detector) as f32, bf16 and int8
    artifacts with a symbolic batch, loaded and called at batch 32 and 5:
    the cyt::* nodes and the launches of each call (K2 x1, K1 x4 for
    f32 / bf16; none for int8), the outputs against the live dark_detect
    path (phase 5's bands), and the ms of a batch of artifact and live fn
    in turns.  Returns the launches of the batch-32 call by dtype."""
    model = predict.restore_darknet(params, model_dir, "last").cuda()
    xs = {b: preprocess_images(list(frames[:b]), 448, "cuda")
          for b in (BATCH, 5)}
    det_kw = dict(n_boxes=1, n_classes=43, img_size=448, conf_th=0.5)
    out = {}
    for dtype in ("float32", "bfloat16", "int8"):
        dt = getattr(torch, dtype)
        with torch.inference_mode():
            if dt == torch.int8:   # calibrated as dark_detect calibrates
                fn = export.make_int8_detector_fn(quant.quantize_darknet(
                    model.state_dict(), x_cal=xs[BATCH]), **det_kw)
            else:
                fn = export.make_detector_fn(model, dtype=dt, **det_kw)
        call, t_exp, t_load, mb = export_and_load(
            fn, (448, 448, 3), root, f"darknet_r_{dtype}")
        nodes = kernel_nodes(call)
        want_nodes = ({} if dt == torch.int8 else
                      {"input_stage": 1, "pool_leaky": 4})
        require(nodes == want_nodes, f"{dtype} artifact nodes {nodes}")
        params.compute_dtype = dtype
        y_hat, _ = predict.dark_detect(list(frames[:BATCH]), model_dir,
                                       params, "last", device="cuda")
        ref = box_conf(y_hat, 1).reshape(BATCH, -1)
        for b, x in xs.items():
            d, launches = counted(call, x)
            want = ({"input_stage": 0, "pool_leaky": 0} if dt == torch.int8
                    else {"input_stage": 1, "pool_leaky": 4})
            require(launches == dict(want, routing=0, routing_bwd=0),
                    f"{dtype} artifact at batch {b}: launches {launches}")
            with torch.inference_mode():
                live = fn(x)
            same = all(torch.equal(d[k], live[k]) for k in live)
            conf, _ = by_candidate(d, 14 * 14)
            err = np.abs(conf.cpu().numpy() - ref[:b])
            print(f"[artifact] darknet_r {dtype} batch {b}: nodes {nodes}, "
                  f"launches {launches}; confidences vs dark_detect's y_hat "
                  f"max_abs_err {err.max()} mean {err.mean()}; equal to the "
                  f"live fn to the bit: {same}")
            if dt == torch.bfloat16:
                require(err.mean() < BF16_BANDS["confidence"],
                        "bf16 artifact outside phase 5's band")
            else:
                require(err.max() <= 5e-4, f"{dtype} artifact outside 5e-4")
            if b == BATCH:
                out[dtype] = launches
        with torch.inference_mode():
            live_ms, art_ms = in_turns(lambda: fn(xs[BATCH]),
                                       lambda: call(xs[BATCH]))
        print(f"[time] darknet_r {dtype} forward+decode batch {BATCH}: "
              f"artifact {art_ms:.3f} ms, live {live_ms:.3f} ms, in turns "
              f"(export {t_exp:.2f} s, load {t_load:.2f} s, {mb:.1f} MB; "
              f"{SMI})")
    return out


def run_classifier_artifacts(frames, crops, dark_dir, classifiers, root):
    """Phase 26: CapsuleNet at batch 64 as f32 and bf16 artifacts (K3 x1
    a call), the fused two-stage --combine capsule | cnn at max_crops 16
    as f32, bf16 and int8 artifacts (K2 x1, K1 x4 a batch but int8; K3
    x1 a batch with CapsuleNet), each against its live path (K3's bands
    for the class scores); ms of artifact and live in turns.  Returns
    the f32 capsule classifier call's launches."""
    cparams = Params(os.path.join(HERE, "experiments", "capsule",
                                  "params.json"), model="capsule")
    x64 = torch.from_numpy(crops[:CAPS_BATCH]).cuda()
    out = {}
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        cparams.compute_dtype = dtype
        model = predict.restore_capsule(cparams, classifiers["capsule"],
                                        "last").cuda()
        fn = export.make_classifier_fn(model)
        call, t_exp, t_load, mb = export_and_load(
            fn, (32, 32, 3), root, f"capsule_{dtype}")
        require(kernel_nodes(call) == {"routing": 1}, "capsule nodes")
        (scores, _), launches = counted(call, x64)
        require(launches == {"routing": 1, "routing_bwd": 0,
                             "pool_leaky": 0, "input_stage": 0},
                f"capsule {dtype} artifact: launches {launches}")
        y_hat, _ = predict.class_pred(crops[:CAPS_BATCH],
                                      classifiers["capsule"], cparams,
                                      "last", device="cuda")
        err = np.abs(scores.cpu().numpy() - y_hat).max()
        np.testing.assert_allclose(scores.cpu().numpy(), y_hat,
                                   **K3_TOL[dt == torch.bfloat16])
        with torch.inference_mode():
            live_ms, art_ms = in_turns(lambda: fn(x64), lambda: call(x64))
        print(f"[artifact] capsule {dtype} batch {CAPS_BATCH}: launches "
              f"{launches}; scores vs class_pred max_abs_err {err}; "
              f"artifact {art_ms:.3f} ms, live {live_ms:.3f} ms in turns "
              f"(export {t_exp:.2f} s, load {t_load:.2f} s, {mb:.1f} MB; "
              f"{SMI})")
        if dtype == "float32":
            out = launches

    xb = preprocess_images(list(frames[:BATCH]), 448, "cuda")
    for name, cdir in classifiers.items():
        for dtype in ("float32", "bfloat16", "int8"):
            dt = getattr(torch, dtype)
            dparams, cp = two_stage_params(name, dtype)
            det = predict.restore_darknet(dparams, dark_dir, "last").cuda()
            cls = predict.restore_classifier(cp, cdir, "last").cuda()
            with torch.inference_mode():
                fn = export.make_serving_two_stage_fn(
                    det, cls, dtype=dt, x_cal=xb, n_boxes=1, n_classes=43,
                    img_size=448, cap_input=32, max_crops=MAX_CROPS,
                    conf_th=0.5, with_grid=True)
            call, t_exp, t_load, mb = export_and_load(
                fn, (448, 448, 3), root, f"two_stage_{name}_{dtype}")
            d, launches = counted(call, xb)
            n_k3 = 1 if name == "capsule" else 0
            want = (dict(two_stage_launches(BATCH, n_k3), input_stage=0,
                         pool_leaky=0) if dt == torch.int8
                    else two_stage_launches(BATCH, n_k3))
            require(launches == want,
                    f"two-stage {name} {dtype} artifact: launches {launches}")
            with torch.inference_mode():
                live = fn(xb)
            require(torch.equal(d["valid"], live["valid"]), "crops differ")
            err = (d["class_scores"] - live["class_scores"]).abs().max()
            torch.testing.assert_close(d["class_scores"],
                                       live["class_scores"],
                                       **K3_TOL[dt == torch.bfloat16])
            with torch.inference_mode():
                live_ms, art_ms = in_turns(lambda: fn(xb), lambda: call(xb))
            print(f"[artifact] two-stage {name} {dtype} batch {BATCH}, "
                  f"max_crops {MAX_CROPS}: nodes {kernel_nodes(call)}, "
                  f"launches {launches}, {int(d['valid'].sum())} crops "
                  f"valid; class scores vs the live fused path max_abs_err "
                  f"{err.item()}; artifact {art_ms:.3f} ms, live "
                  f"{live_ms:.3f} ms in turns (export {t_exp:.2f} s, load "
                  f"{t_load:.2f} s, {mb:.1f} MB; {SMI})")
    return out


def run_routing_choice(crops, labels):
    """Phase 27: --routing on the capsule classifier at batch 64: serving
    and one train step under pallas (K3 x1, K4 x1 counted) and xla (no
    launch), scores and gradients in K3's and K4's bands of each other,
    both times; `resolve_routing_impl("auto")` must pick the faster on
    this card.  Returns the pallas step's launches."""
    cfg = losses.LossConfig.from_params(Params(os.path.join(
        HERE, "experiments", "capsule", "params.json"), model="capsule",
        recon=True, recon_coef=5e-4))
    x = torch.from_numpy(crops[:CAPS_BATCH]).cuda()
    y = torch.from_numpy(labels[:CAPS_BATCH]).cuda()
    state = seeded_capsulenet().state_dict()
    out, times = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        runs = {}
        for impl in ("pallas", "xla"):
            model = CapsuleNet(43, dtype=dtype, routing_impl=impl).cuda()
            model.load_state_dict(state)
            with torch.inference_mode():
                scores, serve_l = counted(model.eval(), x)
            model.train()
            model.zero_grad(set_to_none=True)
            reset_launches()
            loss = steps.loss_and_scores(model, x, y, cfg, "capsule")[0]
            loss.backward()
            torch.cuda.synchronize()
            step_l = read_launches()
            k = 1 if impl == "pallas" else 0
            require(serve_l == {"routing": k, "routing_bwd": 0,
                                "pool_leaky": 0, "input_stage": 0} and
                    step_l == {"routing": k, "routing_bwd": k,
                               "pool_leaky": 0, "input_stage": 0},
                    f"--routing {impl}: launches {serve_l}, {step_l}")
            grads = {n: p.grad.clone() for n, p in model.named_parameters()}
            opt = steps.make_optimizer(model)
            with torch.inference_mode():
                serve_ms = time_ms(lambda: model.eval()(x), iters=10)
            model.train()
            step_ms = time_ms(lambda: steps.train_step(
                model, opt, x, y, 1e-3, cfg, "capsule"), iters=10)
            runs[impl] = (scores, loss.item(), grads, serve_ms, step_ms)
            if impl == "pallas" and dtype == torch.float32:
                out = step_l
        (sp, lp, gp, msp, stp), (sx, lx, gx, msx, stx) = (runs["pallas"],
                                                          runs["xla"])
        # xla routes in f32 whatever the dtype; pallas's bf16 routes on
        # bf16 operands: K3's bf16 band then covers the two
        torch.testing.assert_close(sp, sx, **K3_TOL[bf16])
        worst = max(grad_close(f"--routing {n}", gp[n], gx[n], bf16,
                               scaled=True) for n in gp)
        name = str(dtype)[6:]
        print(f"[routing] capsule {name} batch {CAPS_BATCH}: pallas vs xla "
              f"scores max_abs_err {(sp - sx).abs().max().item()}, loss "
              f"{lp} vs {lx}, gradients max_abs_err {worst} (K3/K4 bands); "
              f"serving pallas {msp:.3f} ms, xla {msx:.3f} ms; train step "
              f"pallas {stp:.3f} ms, xla {stx:.3f} ms ({SMI})")
        times[dtype] = (msp, msx, stp, stx)
    auto = resolve_routing_impl("auto", "capsule", "cuda")
    faster = all(t[0] < t[1] and t[2] < t[3] for t in times.values())
    print(f"[routing] --routing auto on this card resolves to {auto}; "
          f"pallas faster in serving and the step, f32 and bf16: {faster}")
    require(auto == ("pallas" if faster else "xla"),
            "--routing auto did not pick the faster routing on this card")
    return out


def run_remat_and_s2d(x_np, y_np, frames, model_dir, params):
    """Phase 28: one darknet_r train step at 448 px, batch 32, dropout
    0.5, f32 and bf16, with and without --remat (cuDNN deterministic for
    the pair): the loss equal to the bit, each gradient's cosine with
    the plain step's at least 0.99999 (phase 24's rule), BN buffers and
    the generator's state equal; the peak memory and the step's ms of
    each.  Then the s2d int8 chain against the resident chain on the
    card, bit for bit, and both ms in turns."""
    cfg = losses.LossConfig.from_params(dark_train_params("float32"))
    y = torch.from_numpy(y_np[:BATCH]).cuda()
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.from_numpy(x_np[:BATCH]).cuda().to(dtype)
        runs = {}
        for remat in (False, True):
            model = DarkNet(1, 43, dropout=0.5, dtype=dtype, seed=0,
                            remat=remat).cuda().train()
            gen = torch.Generator(device="cuda").manual_seed(0)
            deterministic = torch.backends.cudnn.deterministic
            torch.backends.cudnn.deterministic = True
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            loss = steps.loss_and_scores(model, x, y, cfg, "darknet_r",
                                         gen)[0]
            loss.backward()
            torch.cuda.synchronize()
            peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
            torch.backends.cudnn.deterministic = deterministic
            runs[remat] = (loss.item(), {n: p.grad.clone() for n, p in
                                         model.named_parameters()},
                           {n: b.clone() for n, b in model.named_buffers()},
                           gen.get_state(), peak)
            opt = steps.make_optimizer(model)
            ms = time_ms(lambda: steps.train_step(
                model, opt, x, y, 1e-3, cfg, "darknet_r", gen), iters=5)
            runs[remat] += (ms,)
            del model, opt
        a, b = runs[False], runs[True]
        require(a[0] == b[0], f"remat {dtype}: loss {b[0]} vs {a[0]}")
        cos = min(float((a[1][n].double() * b[1][n].double()).sum()
                        / (a[1][n].double().norm() * b[1][n].double().norm()))
                  for n in a[1])
        err = max(float(((a[1][n] - b[1][n]).abs().max()
                         / a[1][n].abs().max())) for n in a[1])
        require(cos >= 0.99999, f"remat {dtype}: gradient cosine {cos}")
        require(all(torch.equal(a[2][n], b[2][n]) for n in a[2]),
                f"remat {dtype}: BN buffers differ")
        require(torch.equal(a[3], b[3]), f"remat {dtype}: generator state")
        print(f"[remat] darknet_r train step batch {BATCH} {str(dtype)[6:]}"
              f", dropout 0.5 (cuDNN deterministic for the checked step): "
              f"loss {a[0]} equal with remat; gradients' least cosine "
              f"{cos}, largest error over max|g| {err}; BN buffers and "
              f"generator state equal; peak memory of forward+backward "
              f"above the inputs {a[4]:.3f} GiB plain, {b[4]:.3f} GiB remat"
              f" ({b[4] / a[4]:.3f}); step with Adam {a[5]:.3f} ms plain, "
              f"{b[5]:.3f} ms remat ({b[5] / a[5]:.3f}) ({SMI})")

    model = predict.restore_darknet(params, model_dir, "last").cuda()
    xb = preprocess_images(list(frames[:BATCH]), 448, "cuda")
    with torch.inference_mode():
        q = quant.quantize_darknet(model.state_dict(), x_cal=xb)
        qs = quant.prepare_s2d_int8(q)
        kw = dict(n_boxes=1, n_classes=43)
        y8 = quant.darknet_int8_resident_apply(q, xb, **kw)
        ys = quant.darknet_int8_resident_s2d_apply(qs, xb, **kw)
        require(torch.equal(y8, ys), "s2d int8 chain differs from resident")
        res_ms, s2d_ms = in_turns(
            lambda: quant.darknet_int8_resident_apply(q, xb, **kw),
            lambda: quant.darknet_int8_resident_s2d_apply(qs, xb, **kw))
    print(f"[s2d] darknet_r int8 forward batch {BATCH}: the s2d chain equal "
          f"to the resident chain to the bit; resident {res_ms:.3f} ms, s2d "
          f"{s2d_ms:.3f} ms, in turns (phase 22 times the resident chain "
          f"with its decode; {SMI})")

def stream_data(root):
    """Phase 29's data: the 64 + 16 synthetic darknet_r scenes as .npy
    files, uint8 for --stream (memmapped, centered by the prefetcher) and
    centered float32 for the resident run."""
    x_tr, y_tr, x_ev, y_ev = loader.synthetic_dataset(
        "darknet_r", dark_train_params("float32"), DARK_TRAIN_SCENES,
        DARK_EVAL_SCENES)
    dirs = {}
    for tag in ("resident", "stream"):
        d = os.path.join(root, "data_" + tag)
        os.makedirs(d, exist_ok=True)
        for split, x, y in (("train", x_tr, y_tr), ("eval", x_ev, y_ev)):
            u8 = np.clip(x * 128.0 + 128, 0, 255).astype(np.uint8)
            np.save(os.path.join(d, f"{split}_X.npy"), u8 if tag == "stream"
                    else np.asarray(loader.center_rgb(u8), np.float32))
            np.save(os.path.join(d, f"{split}_Y.npy"), y)
        dirs[tag] = d
    return dirs


def run_stream(root, step_ms):
    """Phase 29: darknet_r training (448 px, batch 32, dropout 0.5, 2
    epochs of 64 + 16 scenes) through `train_and_evaluate` with --npy,
    resident and --stream (the memmapped uint8 scenes through the native
    prefetcher and pinned memory), cuDNN deterministic: no kernel
    launch, the losses equal.  Then one train epoch of each after a warm
    one: ms a step, the device's busy share (profile) and the host's wait
    on the prefetcher, beside phase 14's step ms."""
    t_phase = time.perf_counter()
    dirs = stream_data(root)
    got = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for tag in ("resident", "stream"):
            model_dir = os.path.join(root, tag)
            os.makedirs(model_dir, exist_ok=True)
            np.random.seed(0)
            reset_launches()
            with contextlib.redirect_stdout(io.StringIO()):
                driver.train_and_evaluate(
                    dark_train_params("float32", npy=True,
                                      stream=tag == "stream"),
                    dirs[tag], model_dir, seed=0, device="cuda",
                    progress=False)
            launches = read_launches()
            require(sum(launches.values()) == 0,
                    f"stream: a kernel launched in training: {launches}")
            got[tag] = np.concatenate([np.load(os.path.join(
                model_dir, f"losses_{s}.npy")) for s in ("tr", "ev")])
    finally:
        torch.backends.cudnn.deterministic = deterministic
    diff = float(np.max(np.abs(got["stream"] - got["resident"])
                        / np.abs(got["resident"])))
    print(f"[stream] darknet_r 2 epochs, train/eval losses resident "
          f"{got['resident'].tolist()}, --stream {got['stream'].tolist()}; "
          f"largest relative difference {diff} (cuDNN deterministic)")
    require(diff <= 1e-6, f"--stream losses differ from resident by {diff}")
    x_mm, y_mm = data_stream.open_memmap_dataset(dirs["stream"], "train")
    require(isinstance(x_mm, np.memmap) and x_mm.dtype == np.uint8,
            "stream: the scenes are not a uint8 memmap")
    sets = {"resident": (np.load(os.path.join(dirs["resident"],
                                               "train_X.npy")), y_mm),
            "stream": (x_mm, y_mm)}
    for tag, (x, y) in sets.items():
        t = driver.Trainer(dark_train_params("float32",
                                             stream=tag == "stream"),
                           seed=0, device="cuda", verbose=False)
        np.random.seed(0)

        def epoch():
            t.train_epoch(x, y, 1e-3, metric_on=False)

        epoch()  # warm: cuDNN plans, the resident upload
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        epoch()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        n_steps = len(y) // BATCH
        print(f"[stream] {tag}: train epoch of {len(y)} scenes ({n_steps} "
              f"steps of {BATCH}) {wall:.3f} ms = {wall / n_steps:.3f} ms a "
              f"step (phase 14's step: {step_ms[torch.float32]:.3f} ms); "
              f"waiting on the prefetcher {t.prefetch_wait_s * 1e3:.3f} ms "
              f"({SMI})")
        profile_ms(epoch, wall, iters=2, groups=DARK_GROUPS, top=5)
        del t
    shutil.rmtree(root)
    print(f"[stream] phase 29 wall {time.perf_counter() - t_phase:.1f} s")


def mesh_step_case(name, crops, labels, dx, dy):
    """(params, x, y) of phase 30's steps: CapsuleNet at batch 64 through
    K3/K4 (--routing pallas), darknet_r at 448 px, batch 32, dropout
    0.5."""
    if name == "capsule":
        p = Params(os.path.join(HERE, "experiments", "capsule",
                                "params.json"), model="capsule",
                   n_epochs=1, lr_runtime=1e-3, recon=True, recon_coef=5e-4,
                   eval_every=1, train_frac=1, summary=False,
                   routing_impl="pallas")
        return (p, torch.from_numpy(np.asarray(crops[:CAPS_BATCH],
                                               np.float32)),
                torch.from_numpy(np.asarray(labels[:CAPS_BATCH], np.int64)))
    return (dark_train_params("float32"),
            torch.from_numpy(np.asarray(dx[:BATCH], np.float32)),
            torch.from_numpy(np.asarray(dy[:BATCH], np.float32)))


def mesh_step(trainer, x, y):
    """One train step of ``trainer`` on the global batch (x, y), this
    rank's rows through it (`parallel.mesh.place_batch`), with its launch
    counts; returns (global loss, state after, launches, the step)."""
    n = x.shape[0]
    if trainer.mesh is None:
        xb, yb = x.cuda(), y.cuda()
    else:
        xb, yb = par.place_batch((x, y), trainer.mesh)
    shard, group = trainer._shard(n)

    def step():
        return steps.train_step(trainer.model, trainer.opt, xb, yb, 1e-3,
                                trainer.loss_cfg, trainer.model_name,
                                trainer.generator, shard=shard,
                                grad_group=group)

    trainer.model.train()
    reset_launches()
    loss = step()[0]
    torch.cuda.synchronize()
    launches = read_launches()
    if trainer.mesh is not None:
        loss = par.all_reduce_rows(loss[None], trainer.mesh)[0] \
            / trainer.mesh.n_data
    state = {"grads": {k: p.grad.clone() for k, p in
                       trainer.model.named_parameters()},
             "params": {k: p.detach().clone() for k, p in
                        trainer.model.named_parameters()},
             "buffers": {k: b.clone() for k, b in
                         trainer.model.named_buffers()},
             "rng": (None if trainer.generator is None
                     else trainer.generator.get_state())}
    return loss.item(), state, launches, step


def cosine(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return float((a @ b) / (a.norm() * b.norm()))


def mesh_rank(local_rank, port, root, model_dir):
    """Phase 30's two ranks on the one card, over gloo (NCCL refuses two
    ranks of one communicator on one device): a CapsuleNet step at
    global batch 64 (32 rows a rank: K3 x1, K4 x1 on each) and its ms,
    then darknet_r serving of phase 5's 64 scenes at batch 32 through
    `dark_detect` (16 rows a rank: K2 x1, K1 x4 a batch on each); writes
    what phase 30 checks to root/rank<r>.pt."""
    par.initialize_distributed(f"127.0.0.1:{port}", 2, local_rank, "gloo")
    try:
        torch.cuda.set_device(0)
        resolve_device("cuda")
        mesh = par.make_mesh(n_data=2, device="cuda:0")
        data = np.load(os.path.join(root, "data.npz"))
        p, x, y = mesh_step_case("capsule", data["crops"], data["labels"],
                                 None, None)
        t = driver.Trainer(p, seed=0, device="cuda", verbose=False,
                           mesh=mesh)
        loss, state, caps_launches, step = mesh_step(t, x, y)
        ms = time_ms(step, iters=10)
        params = Params(os.path.join(HERE, "experiments", "darknet_r",
                                     "params.json"), model="darknet_r",
                        batch_size=BATCH, compute_dtype="float32")
        reset_launches()
        y_hat, _ = predict.dark_detect(list(data["frames"]), model_dir,
                                       params, "last", mesh=mesh)
        torch.cuda.synchronize()
        torch.save({"loss": loss, "grads": {k: v.cpu() for k, v in
                                            state["grads"].items()},
                    "launches": caps_launches, "ms": ms, "y_hat": y_hat,
                    "serve_launches": read_launches()},
                   os.path.join(root, f"rank{local_rank}.pt"))
        torch.distributed.barrier()
    finally:
        torch.distributed.destroy_process_group()


def run_mesh(root, frames, model_dir, crops, labels, dx, dy):
    """Phase 30: the mesh on the card.  A one-rank NCCL group through the
    module API (make_mesh(n_data=1)): one CapsuleNet step (K3 x1, K4 x1)
    and one darknet_r step, each equal to the bit to the plain Trainer's
    (loss, gradients, parameters after Adam, BN buffers, generator;
    cuDNN deterministic; a data axis of one syncs no BN, the gradients
    go through the all-reduce), and each step's ms with and without the
    mesh.  Then two spawned ranks on the one card over gloo
    (`mesh_rank`): the capsule step's gradients in K4's bands of the
    single step, the serving y_hat within phase 5's f32 band of
    single-process `dark_detect`, and the launches on each rank.
    Returns the launches of the paths, counted as the kernels line
    counts them."""
    import torch.multiprocessing as mp

    t_phase = time.perf_counter()
    os.makedirs(root, exist_ok=True)
    counted = {k: 0 for k in kernel_wrappers()}
    port = par._free_port()
    par.initialize_distributed(f"127.0.0.1:{port}", 1, 0, "nccl")
    try:
        mesh = par.make_mesh(n_data=1, device="cuda:0")
        for name in ("capsule", "darknet_r"):
            p, x, y = mesh_step_case(name, crops, labels, dx, dy)
            runs = {}
            for tag, m in (("plain", None), ("mesh", mesh)):
                t = driver.Trainer(p, seed=0, device="cuda", verbose=False,
                                   mesh=m)
                deterministic = torch.backends.cudnn.deterministic
                torch.backends.cudnn.deterministic = True
                torch.use_deterministic_algorithms(True, warn_only=True)
                try:
                    loss, state, launches, step = mesh_step(t, x, y)
                finally:
                    torch.use_deterministic_algorithms(False)
                    torch.backends.cudnn.deterministic = deterministic
                runs[tag] = (loss, state, launches, time_ms(step, iters=10))
                del t
            (la, sa, na, ma), (lb, sb, nb, mb) = runs["plain"], runs["mesh"]
            want = ({"routing": 1, "routing_bwd": 1} if name == "capsule"
                    else {})
            for n in (na, nb):
                require(n == dict({k: 0 for k in counted}, **want),
                        f"mesh {name}: launches {n}")
            for k in counted:
                counted[k] += nb[k]
            require(la == lb, f"mesh {name}: loss {lb} vs {la}")
            for part in ("grads", "params", "buffers"):
                require(all(torch.equal(sa[part][k], sb[part][k])
                            for k in sa[part]), f"mesh {name}: {part} differ")
            require(sa["rng"] is None or torch.equal(sa["rng"], sb["rng"]),
                    f"mesh {name}: generator state differs")
            print(f"[mesh] {name} step, one-rank NCCL mesh (data=1): loss, "
                  f"gradients, parameters after Adam, BN buffers and "
                  f"generator equal to the plain Trainer's to the bit; "
                  f"launches {nb}; {ma:.3f} ms plain, {mb:.3f} ms on the "
                  f"mesh ({mb / ma:.3f}) ({SMI})")
    finally:
        torch.distributed.destroy_process_group()

    p, x, y = mesh_step_case("capsule", crops, labels, dx, dy)
    single = driver.Trainer(p, seed=0, device="cuda", verbose=False)
    _, want, _, step = mesh_step(single, x, y)
    single_ms = time_ms(step, iters=10)
    params = Params(os.path.join(HERE, "experiments", "darknet_r",
                                 "params.json"), model="darknet_r",
                    batch_size=BATCH, compute_dtype="float32")
    y_want, _ = predict.dark_detect(list(frames), model_dir, params, "last")
    np.savez(os.path.join(root, "data.npz"), frames=frames,
             crops=np.asarray(crops[:CAPS_BATCH], np.float32),
             labels=np.asarray(labels[:CAPS_BATCH], np.int64))
    t0 = time.perf_counter()
    mp.spawn(mesh_rank, args=(par._free_port(), root, model_dir), nprocs=2,
             join=True)
    spawn_wall = time.perf_counter() - t0
    n_batches = -(-len(frames) // BATCH)
    for r in range(2):
        got = torch.load(os.path.join(root, f"rank{r}.pt"),
                         weights_only=False)
        require(got["launches"] == {"pool_leaky": 0, "input_stage": 0,
                                    "routing": 1, "routing_bwd": 1},
                f"gloo mesh rank {r}: capsule step launches "
                f"{got['launches']}")
        require(got["serve_launches"] == {
            "pool_leaky": 4 * n_batches, "input_stage": n_batches,
            "routing": 0, "routing_bwd": 0},
            f"gloo mesh rank {r}: serving launches {got['serve_launches']}")
        for k in counted:
            counted[k] += got["launches"][k] + got["serve_launches"][k]
        key = "traffic_sign_capsules.route_weights"
        w_err = grad_close(key, got["grads"][key].cuda(), want["grads"][key],
                           False, scaled=True)
        cos = min(cosine(got["grads"][k].cuda(), want["grads"][k])
                  for k in want["grads"] if k != key)
        require(cos >= 0.99999, f"gloo mesh rank {r}: a gradient's cosine "
                f"with the single step's is {cos}")
        err = np.abs(got["y_hat"] - y_want)
        require(err.max() <= 5e-4, f"gloo mesh rank {r}: serving y_hat off "
                f"by {err.max()}")
        print(f"[mesh] two gloo ranks on one card, rank {r}: capsule step "
              f"(32 of 64 rows) launches {got['launches']}, route weights' "
              f"gradient in K4's bands of the single step's (largest error "
              f"{w_err}), the others' least cosine {cos} (cuDNN at batch "
              f"32 against 64), "
              f"step {got['ms']:.3f} ms against {single_ms:.3f} ms single "
              f"at 64; dark_detect of {len(frames)} scenes at batch {BATCH} "
              f"(16 rows a rank) launches {got['serve_launches']}, y_hat "
              f"max_abs_err {err.max()} against single-process ({SMI})")
    shutil.rmtree(root)
    print(f"[mesh] phase 30 wall {time.perf_counter() - t_phase:.1f} s "
          f"(the two spawned ranks {spawn_wall:.1f} s)")
    return counted


def run_async_ckpt(root):
    """Phase 31: darknet_r training, 3 epochs of 64 + 16 scenes with
    --ckpt_every 2, synchronous then --async_ckpt (cuDNN deterministic):
    the same checkpoint files holding the same tensors; each run's wall
    a epoch."""
    t_phase = time.perf_counter()
    walls, files = {}, {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for tag in ("sync", "async"):
            model_dir = os.path.join(root, tag)
            os.makedirs(model_dir, exist_ok=True)
            np.random.seed(0)
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                driver.train_and_evaluate(
                    dark_train_params("float32", n_epochs=3, ckpt_every=2,
                                      async_ckpt=tag == "async"),
                    os.path.join(model_dir, "nodata"), model_dir, seed=0,
                    device="cuda", progress=False)
            torch.cuda.synchronize()
            walls[tag] = (time.perf_counter() - t0) / 3
            d = model_dir + "1"
            files[tag] = {f: ckpt.load_checkpoint(os.path.join(d, f))
                          for f in sorted(os.listdir(d))}
    finally:
        torch.backends.cudnn.deterministic = deterministic
    require(list(files["sync"]) == list(files["async"])
            and "last.ckpt" in files["sync"],
            f"async_ckpt files {list(files['async'])} vs "
            f"{list(files['sync'])}")
    for f, want in files["sync"].items():
        got = files["async"][f]
        require(got["epoch"] == want["epoch"] == (3 if f == "last.ckpt"
                                                  else want["epoch"]),
                f"async_ckpt {f}: epoch {got['epoch']}")
        for part in ("state_dict",):
            require(all(torch.equal(got[part][k], want[part][k])
                        for k in want[part]), f"async_ckpt {f}: {part}")
        for i, st in want["optim_dict"]["state"].items():
            require(all(torch.equal(got["optim_dict"]["state"][i][k], v)
                        for k, v in st.items()),
                    f"async_ckpt {f}: Adam state {i}")
    shutil.rmtree(root)
    print(f"[async_ckpt] darknet_r 3 epochs, --ckpt_every 2: files "
          f"{list(files['sync'])} equal sync and async (epochs "
          f"{[c['epoch'] for c in files['sync'].values()]}); wall a epoch "
          f"(train, eval, checkpoints) {walls['sync']:.3f} s sync, "
          f"{walls['async']:.3f} s async ({SMI}); phase 31 wall "
          f"{time.perf_counter() - t_phase:.1f} s")


@contextlib.contextmanager
def cudnn_deterministic():
    """cuDNN's deterministic algorithms inside the block (phases 13 and
    28-32 hold pairs of runs equal to the bit under them)."""
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before


def scan_params(name, dtype, **over):
    """Phase 32's params: ``name``'s params.json as the CLI's train mode
    sets it (phases 11, 13, 15, 19, 20), in ``dtype``."""
    if name == "capsule":
        p = Params(os.path.join(HERE, "experiments", "capsule",
                                "params.json"), model="capsule",
                   n_epochs=TRAIN_EPOCHS, lr_runtime=1e-3, recon=True,
                   recon_coef=5e-4, eval_every=1, train_frac=1,
                   summary=False, compute_dtype=dtype)
    else:
        p = {"cnn": cnn_params, "darknet_r": dark_train_params,
             "darknet_d": darknet_d_params,
             "darkcapsule": darkcapsule_params}[name](dtype)
    p.__dict__.update(over)
    return p


def scan_trainer(p, scan, mesh=None):
    """A Trainer of ``p`` from seed 0 on the card, --scan_epoch on or
    off."""
    p.scan_epoch = "on" if scan else "off"
    t = driver.Trainer(p, seed=0, device="cuda", verbose=False, mesh=mesh)
    require(t.scan_epoch == scan, f"scan_epoch {t.scan_epoch} for {scan}")
    return t


def scan_run(t, data, n_epochs=TRAIN_EPOCHS):
    """``n_epochs`` train and eval epochs of ``t`` at lr 1e-3 from
    np.random seed 0, metric off; returns each epoch's per-batch losses
    and outputs, and the state after: parameters and BN buffers, Adam's
    state, the dropout generator's state."""
    x, y, xe, ye = data
    np.random.seed(0)
    epochs = []
    with contextlib.redirect_stdout(io.StringIO()):  # darknet_d's avg iou
        for _ in range(n_epochs):
            t.train_epoch(x, y, 1e-3, metric_on=False)
            epochs.append((t.last_losses.clone(), torch.cat(t.last_outputs)))
            t.eval_epoch(xe, ye, metric_on=False)
            epochs.append((t.last_losses.clone(), torch.cat(t.last_outputs)))
    torch.cuda.synchronize()
    params = [q for g in t.opt.param_groups for q in g["params"]]
    state = {"model": {k: v.detach().clone()
                       for k, v in t.model.state_dict().items()},
             "adam": [{k: v.clone() for k, v in t.opt.state[q].items()}
                      for q in params],
             "rng": None if t.generator is None else t.generator.get_state()}
    return epochs, state


def tree_diff(a, b):
    """The largest |a - b| over two nests of tensors (0.0: equal to the
    bit; inf where shapes, types or other values differ)."""
    if isinstance(a, torch.Tensor):
        if a.shape != b.shape or a.dtype != b.dtype:
            return float("inf")
        if torch.equal(a, b):
            return 0.0
        if not a.is_floating_point():
            return float("inf")
        return (a.double() - b.double()).abs().max().item()
    if isinstance(a, dict):
        return max([tree_diff(a[k], b[k]) for k in a] + [0.0])
    if isinstance(a, (list, tuple)):
        return max([tree_diff(u, v) for u, v in zip(a, b)] + [0.0])
    return 0.0 if a == b else float("inf")


def check_scan_pair(label, p, data, mesh=None, launches=None):
    """Phase 32's equality: 2 train and eval epochs of ``p`` through the
    loop and captured (on ``mesh`` when given), cuDNN deterministic; the
    per-batch losses and outputs of every epoch and the state after must
    be equal to the bit, or, where the loop differs from itself, within
    that band.  ``launches``: the counts the captured run must show.
    Returns the captured Trainer and its counts."""
    with cudnn_deterministic():
        loop = scan_trainer(p, False)
        want = scan_run(loop, data)
        del loop
        scan = scan_trainer(p, True, mesh)
        reset_launches()
        got = scan_run(scan, data)
        counts = read_launches()
        diff = tree_diff(got, want)
        band = 0.0
        if diff:
            again = scan_trainer(p, False)
            band = tree_diff(scan_run(again, data), want)
            del again
    require(diff == 0.0 or diff <= band < float("inf"),
            f"{label}: captured epochs differ from the loop's by {diff}, "
            f"the loop from itself by {band}")
    if launches is not None:
        require(counts == dict({k: 0 for k in counts}, **launches),
                f"{label}: launches {counts}, want {launches}")
    n = [len(e[0]) for e in got[0][:2]]
    print(f"[scan_epoch] {label}: {TRAIN_EPOCHS} train and eval epochs "
          f"({n[0]} + {n[1]} batches), captured against the loop: "
          + ("equal to the bit (losses of every batch, outputs, "
             "parameters, BN buffers, Adam state, generator)" if not diff
             else f"largest difference {diff}, within the loop's own "
             f"{band}") + f"; captured launches {counts}")
    return scan, counts


def kernel_profile(fn, logdir):
    """Kernel time (ms) and each kernel's count over one ``fn()``, traced
    by the port's `profiling.trace` into ``logdir``."""
    with profiling.trace(logdir):
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in profiling.trace.last.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0
               and not e.key.startswith("Optimizer.")]
    return (sum(e.self_device_time_total for e in kernels) / 1e3,
            {e.key: e.count for e in kernels})


def time_scan_case(label, p, data, scan, root, k3k4=False):
    """Phase 32's timing of one model and dtype, cuDNN as it runs by
    default: a loop Trainer and the captured one (``scan``, its graphs
    captured anew here); the capture's seconds, then SCAN_TURNS turns of
    a train and an eval epoch each way (alternating which goes first;
    `profiling.StepTimer`s), the transient peak memory of an epoch each
    way and the captured graphs' pool, and one train epoch each way
    traced under ``root`` (`profiling.trace`; busy share).  ``k3k4``: the
    profile of the captured train epoch must count one K3 and one K4 a
    batch, as the launch counts do.  Returns whether the captured epoch
    is no slower than the loop beyond the loop's spread."""
    x, y, xe, ye = data
    scan.drop_graphs()
    loop = scan_trainer(p, False)

    def epoch(t, train):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            if train:
                t.train_epoch(x, y, 1e-3, metric_on=False)
            else:
                t.eval_epoch(xe, ye, metric_on=False)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    first = {tag: epoch(t, True) + epoch(t, False)
             for tag, t in (("loop", loop), ("scan", scan))}
    capture_s = scan._capture.seconds
    pool = sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) ==
               tuple(scan._capture.pool)) / 2 ** 30
    timers = {tag: {kind: profiling.StepTimer(warmup=0)
                    for kind in ("train", "eval")} for tag in ("loop", "scan")}
    mem = {}
    for turn in range(SCAN_TURNS):
        order = (("loop", loop), ("scan", scan))
        for tag, t in (order if turn % 2 == 0 else order[::-1]):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            for kind in ("train", "eval"):
                with timers[tag][kind]:
                    epoch(t, kind == "train")
            if turn == 0:  # the epoch's transient peak, above what stays
                mem[tag] = (torch.cuda.max_memory_allocated()
                            - base) / 2 ** 30
    walls = {tag: {k: v.times for k, v in w.items()}
             for tag, w in timers.items()}
    n_train = -(-len(y) // p.batch_size)
    med = {tag: {k: float(np.median(v)) for k, v in w.items()}
           for tag, w in walls.items()}
    busy = {}
    for tag, t in (("loop", loop), ("scan", scan)):
        reset_launches()
        ms, counts = kernel_profile(lambda: epoch(t, True), os.path.join(
            root, "trace", label.replace(" ", "_") + "_" + tag))
        launches = read_launches()
        busy[tag] = ms / (med[tag]["train"] * 1e3)
        if k3k4 and tag == "scan":
            k3 = sum(c for k, c in counts.items()
                     if "routing_kernel" in k and "bwd" not in k)
            k4 = sum(c for k, c in counts.items() if "bwd_prep_kernel" in k)
            require((k3, k4) == (n_train, n_train) == (
                launches["routing"], launches["routing_bwd"]),
                f"{label}: the profile of a captured train epoch counts "
                f"K3 {k3}, K4 {k4}, the wrappers {launches}, for "
                f"{n_train} batches")
            print(f"[scan_epoch] {label}: a captured train epoch of "
                  f"{n_train} batches: the profiler counts K3 {k3} and K4 "
                  f"{k4} kernels inside the replays, the wrappers' counts "
                  f"{launches['routing']} and {launches['routing_bwd']}")
    for tag in ("loop", "scan"):
        w = walls[tag]["train"]
        print(f"[scan_epoch] {label} {tag}: train epoch median "
              f"{med[tag]['train'] * 1e3:.3f} ms (spread "
              f"{(max(w) - min(w)) * 1e3:.3f} over {len(w)} turns), "
              f"{med[tag]['train'] * 1e3 / n_train:.3f} ms a step over "
              f"{n_train} steps, busy {busy[tag]:.3f}; eval epoch median "
              f"{med[tag]['eval'] * 1e3:.3f} ms; first epoch (train + "
              f"eval) {first[tag]:.3f} s"
              + (f" incl. {capture_s:.3f} s of capture" if tag == "scan"
                 else "")
              + f"; an epoch's transient peak {mem[tag]:.3f} GiB"
              + (f", graph pool {pool:.3f} GiB" if tag == "scan" else "")
              + f" ({SMI})")
    spread = max(walls["loop"]["train"]) - min(walls["loop"]["train"])
    ok = med["scan"]["train"] <= med["loop"]["train"] + spread
    print(f"[scan_epoch] {label}: captured/loop train epoch "
          f"{med['scan']['train'] / med['loop']['train']:.3f}, eval "
          f"{med['scan']['eval'] / med['loop']['eval']:.3f}; captured no "
          f"slower than the loop beyond its spread: {ok}")
    del loop
    return ok


def run_scan_epochs(root):
    """Phase 32: --scan_epoch, each train and eval epoch as replays of
    captured CUDA graphs, against the per-batch loop.  Returns the
    counted launches of its K3/K4 paths (the f32 captured capsule runs)."""
    t_phase = time.perf_counter()
    counted = {k: 0 for k in kernel_wrappers()}
    # through the entry point: capsule train_and_evaluate, on against off
    ckpts = {}
    for scan in ("off", "on"):
        p = scan_params("capsule", "float32", scan_epoch=scan)
        model_dir = os.path.join(root, "capsule_" + scan)
        os.makedirs(model_dir, exist_ok=True)
        np.random.seed(0)
        with cudnn_deterministic(), contextlib.redirect_stdout(
                io.StringIO()):
            reset_launches()
            driver.train_and_evaluate(p, os.path.join(root, "nodata"),
                                      model_dir, seed=0, device="cuda",
                                      progress=False)
            torch.cuda.synchronize()
            launches = read_launches()
        ckpts[scan] = (ckpt.load_checkpoint(os.path.join(
            model_dir + "1", "last.ckpt")), np.load(os.path.join(
                model_dir, "losses_tr.npy")), launches)
    n_tr, n_ev = -(-TRAIN_CROPS // CAPS_BATCH), -(-EVAL_CROPS // CAPS_BATCH)
    want = {"routing": (n_tr + n_ev) * TRAIN_EPOCHS,
            "routing_bwd": n_tr * TRAIN_EPOCHS, "pool_leaky": 0,
            "input_stage": 0}
    (a, la, na), (b, lb, nb) = ckpts["off"], ckpts["on"]
    require(na == nb == want, f"train_and_evaluate launches {na}, {nb}")
    require(np.array_equal(la, lb) and tree_diff(
        [a["state_dict"], a["optim_dict"]["state"]],
        [b["state_dict"], b["optim_dict"]["state"]]) == 0.0
        and a["optim_dict"]["param_groups"] == b["optim_dict"][
            "param_groups"],
        "train_and_evaluate --scan_epoch on: last.ckpt or losses differ")
    require(isinstance(b["optim_dict"]["param_groups"][0]["lr"], float)
            and all(st["step"].device.type == "cpu" for st in
                    b["optim_dict"]["state"].values()),
            "optim_dict not in the reference format")
    for k in counted:
        counted[k] += nb[k]
    print(f"[scan_epoch] capsule f32 train_and_evaluate ({TRAIN_EPOCHS} "
          f"epochs of {n_tr} + {n_ev} batches), --scan_epoch on against "
          f"off: last.ckpt (weights, Adam state in the reference format) "
          f"and train losses {lb} equal to the bit; launches {nb}")

    verdicts = {}
    for name, n_train, n_eval in SCAN_CASES:
        data = loader.synthetic_dataset(name, scan_params(name, "float32"),
                                        n_train, n_eval)
        for dtype in ("float32", "bfloat16"):
            label = f"{name} {dtype}"
            p = scan_params(name, dtype)
            launches = None
            if name == "capsule":
                tr, ev = (-(-n // CAPS_BATCH) for n in (n_train, n_eval))
                launches = {"routing": (tr + ev) * TRAIN_EPOCHS,
                            "routing_bwd": tr * TRAIN_EPOCHS}
            scan, counts = check_scan_pair(label, p, data,
                                           launches=launches)
            if name == "capsule" and dtype == "float32":
                for k in counted:
                    counted[k] += counts[k]
            if name == "capsule" and dtype == "bfloat16":
                with cudnn_deterministic():
                    check_bf16_eval(scan, data)
            verdicts[label] = time_scan_case(label, scan_params(name, dtype),
                                             data, scan, root,
                                             k3k4=name == "capsule")
            del scan
            torch.cuda.empty_cache()
        if name == "darknet_r":
            check_scan_pair("darknet_r f32 --remat",
                            scan_params(name, "float32", remat=True), data)
        if name == "capsule":
            counts = check_scan_mesh(data)
            for k in counted:
                counted[k] += counts[k]
        del data
    print(f"[scan_epoch] captured no slower than the loop (beyond the "
          f"loop's spread) for every model and dtype: "
          f"{all(verdicts.values())} ({sum(verdicts.values())} of "
          f"{len(verdicts)}); auto on the card is "
          f"{driver.SCAN_EPOCH_AUTO_ON_CARD}")
    shutil.rmtree(root)
    print(f"[scan_epoch] phase 32 wall {time.perf_counter() - t_phase:.1f} s")
    return counted


def check_bf16_eval(scan, data):
    """Phase 32, bf16 capsule: after the train replays, a captured eval
    batch equals an eager eval forward of the same crops on the current
    weights (the bf16 route weights are cast inside the eval graph)."""
    _, _, xe, ye = data
    scan.eval_epoch(xe, ye, metric_on=False)
    got = scan.last_outputs[0].clone()
    n = got.shape[0]
    scan.model.eval()
    with torch.no_grad():
        x_dev = torch.from_numpy(np.asarray(xe[:n], np.float32)).cuda()
        y_dev = torch.from_numpy(np.asarray(ye[:n], np.int64)).cuda()
        want = steps.eval_step(scan.model, x_dev, y_dev, scan.loss_cfg,
                               "capsule")[1]
    require(torch.equal(got, want), "bf16 capsule: a captured eval batch "
            f"differs from the eager forward by "
            f"{(got - want).abs().max().item()}")
    print("[scan_epoch] capsule bfloat16: after the train replays a "
          "captured eval batch equals the eager forward on the current "
          "route weights, to the bit")


def check_scan_mesh(data):
    """Phase 32 on a one-rank NCCL mesh (make_mesh(n_data=1), as phase
    30): the captured capsule f32 epochs, the gradient all-reduce inside
    the train graph, against the plain Trainer's loop.  Returns the
    captured run's launches."""
    port = par._free_port()
    par.initialize_distributed(f"127.0.0.1:{port}", 1, 0, "nccl")
    try:
        mesh = par.make_mesh(n_data=1, device="cuda:0")
        tr, ev = (-(-len(d) // CAPS_BATCH) for d in (data[1], data[3]))
        scan, counts = check_scan_pair(
            "capsule f32 on a one-rank NCCL mesh", scan_params(
                "capsule", "float32"), data, mesh=mesh,
            launches={"routing": (tr + ev) * TRAIN_EPOCHS,
                      "routing_bwd": tr * TRAIN_EPOCHS})
        del scan
    finally:
        torch.distributed.destroy_process_group()
    return counts


def main():
    global SMI
    # phase 1
    require(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    SMI = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(SMI)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {kind}")
    resolve_device("cuda")  # TF32 off for every f32 conv below

    # phase 2
    t0 = time.perf_counter()
    _build.build(verbose=True)  # ptxas: registers, shared memory, spills
    _build.library()
    print(f"[build] kernels built and loaded in "
          f"{time.perf_counter() - t0:.2f} s")

    # phases 3-4
    pool_err = check_pool()
    is_err = check_input_stage()

    # phase 5
    params = Params(os.path.join(HERE, "experiments", "darknet_r",
                                 "params.json"), model="darknet_r",
                    batch_size=BATCH)
    require((params.n_boxes, params.n_classes, params.n_grid,
             params.darknet_input) == (1, 43, 14, 448), "darknet_r config")
    _, _, x, y_true = loader.synthetic_dataset("darknet_r", params, 0, 64)
    frames = np.clip(x * 128.0 + 128, 0, 255).astype(np.uint8)
    model_dir = os.path.join(HERE, "build", "chip_smoke", "darknet_r")
    ckpt.save_checkpoint({"epoch": 0, "optim_dict": {},
                          "state_dict": seeded_darknet(frames).state_dict()},
                         False, model_dir)
    slice_launches = run_slice(frames, y_true, model_dir, params)
    launches = slice_launches["float32"]  # phase 18's added at the end

    # phase 6
    model = predict.restore_darknet(params, model_dir, "last").cuda()
    k1 = time_pool()
    k2s = time_input_stage(model.state_dict())
    k2, k2b = k2s[torch.float32], k2s[torch.bfloat16]
    serving_ms = time_serving(model, frames)

    # phase 7
    k3_err = check_routing()

    # phase 8
    cparams = Params(os.path.join(HERE, "experiments", "capsule",
                                  "params.json"), model="capsule")
    require((cparams.batch_size, cparams.n_classes) == (CAPS_BATCH, 43),
            "capsule config")
    _, _, crops, labels = loader.synthetic_dataset("capsule", cparams, 0,
                                                   CAPS_CROPS)
    cmodel_dir = os.path.join(HERE, "build", "chip_smoke", "capsule")
    ckpt.save_checkpoint({"epoch": 0, "optim_dict": {},
                          "state_dict": seeded_capsulenet().state_dict()},
                         False, cmodel_dir)
    caps_launches = run_capsule_slice(crops, labels, cmodel_dir, cparams)

    # phase 9
    cparams.compute_dtype = "float32"
    cmodel = predict.restore_capsule(cparams, cmodel_dir, "last").cuda()
    for io in (torch.float32, torch.bfloat16):
        print(f"[config] K3 and K4 at B {CAPS_BATCH}, N 1296, K 43, n_iter 3, "
              f"{io}: {routing.kernel_config(CAPS_BATCH, 1296, 43, 3, io)}")
    k3 = time_routing(cmodel.traffic_sign_capsules.route_weights[0].detach())
    time_capsule_serving(cmodel, crops)

    # phase 10
    k4_err = check_routing_bwd()

    # phase 11
    tparams = Params(os.path.join(HERE, "experiments", "capsule",
                                  "params.json"), model="capsule",
                     n_epochs=TRAIN_EPOCHS, lr_runtime=1e-3, recon=True,
                     recon_coef=5e-4, eval_every=1, train_frac=1,
                     summary=False)
    require(tparams.batch_size == CAPS_BATCH, "capsule config")
    tcrops, tlabels, _, _ = loader.synthetic_dataset(
        "capsule", tparams, TRAIN_CROPS, EVAL_CROPS)
    check_train_step(tparams, tcrops, tlabels)
    train_launches = run_train_slice(
        tparams, os.path.join(HERE, "build", "chip_smoke", "capsule_train"))

    # phase 12
    k4 = time_routing_bwd(
        cmodel.traffic_sign_capsules.route_weights[0].detach())
    time_train_step(tparams, tcrops, tlabels)

    # phase 13
    dx, dy, _, _ = loader.synthetic_dataset(
        "darknet_r", dark_train_params("float32"), BATCH, 0)
    dark_launches = run_dark_train_slice(
        frames, y_true, dx, dy, os.path.join(HERE, "build", "chip_smoke",
                                             "darknet_r_train"))
    print(f"[dark_train] launches on the predict leg from the f32-trained "
          f"checkpoint: {dark_launches}")

    # phase 14
    dark_step_ms = time_dark_train_step(dark_train_params("float32"), dx, dy)

    # phase 15
    cnn_dir = run_cnn_train_slice(os.path.join(HERE, "build", "chip_smoke",
                                               "cnn_train"))

    # phase 16: phase 5's detector, phase 8's and phase 15's classifiers
    classifiers = {"capsule": cmodel_dir, "cnn": cnn_dir}
    host = run_two_stage_host(frames, model_dir, classifiers)

    # phase 17
    check_routing_b512(
        cmodel.traffic_sign_capsules.route_weights[0].detach())
    fused = run_two_stage_fused(frames, model_dir, classifiers)
    print(f"[two_stage] launches: host {host}; fused capsule {fused}")

    # phase 18
    d_root = os.path.join(HERE, "build", "chip_smoke", "darknet_d")
    d_frames, d_y, d_dir, d_launches = run_darknet_d_serving(d_root)

    # phase 19
    d_train = run_darknet_d_train(d_frames, d_y,
                                  os.path.join(d_root, "train"))
    d_combine = run_darknet_d_combine(d_frames, d_y, d_dir, classifiers)
    print(f"[darknet_d] launches: serving {d_launches}; predict leg from "
          f"the f32-trained checkpoint {d_train}; --combine {d_combine}")

    # phase 20
    run_darkcapsule(os.path.join(HERE, "build", "chip_smoke", "darkcapsule"))

    # phase 21: phase 5's detector, phase 8's and phase 15's classifiers
    outputs = run_predict_outputs(
        frames, y_true, model_dir, classifiers,
        os.path.join(HERE, "build", "chip_smoke", "outputs"))

    # phase 22
    int8_launches, _ = run_int8_serving(
        frames, model_dir, params, serving_ms,
        os.path.join(HERE, "build", "chip_smoke", "int8"))

    # phase 23
    int8_two_stage = run_int8_two_stage(frames, model_dir, classifiers)
    print(f"[int8] launches: serving {int8_launches}; two-stage "
          f"{int8_two_stage}; phase 21's runs {outputs}")

    # phase 24
    run_wgrad_precision(dy)

    # phases 25-28: the serving artifacts, --routing, --remat and s2d
    art_root = os.path.join(HERE, "build", "chip_smoke", "artifacts")
    art_launches = run_detector_artifacts(frames, model_dir, params,
                                          art_root)
    caps_art = run_classifier_artifacts(frames, crops, model_dir,
                                        classifiers, art_root)
    shutil.rmtree(art_root)
    routing_launches = run_routing_choice(tcrops, tlabels)
    run_remat_and_s2d(dx, dy, frames, model_dir, params)

    # phases 29-31: --stream, the mesh, --async_ckpt --ckpt_every
    run_stream(os.path.join(HERE, "build", "chip_smoke", "stream"),
               dark_step_ms)
    mesh_launches = run_mesh(os.path.join(HERE, "build", "chip_smoke",
                                          "mesh"), frames, model_dir,
                             crops, labels, dx, dy)
    run_async_ckpt(os.path.join(HERE, "build", "chip_smoke", "async_ckpt"))

    # phase 32: --scan_epoch
    scan_launches = run_scan_epochs(os.path.join(HERE, "build", "chip_smoke",
                                                 "scan_epoch"))

    # K1 and K2 on the main paths: darknet_r's (phase 5) and darknet_d's
    # (phase 18) serving, the detector artifacts' (phase 25) and mesh
    # serving (phase 30, f32); K3 on the capsule slice (phase 8), its
    # artifact (phase 26) and the mesh steps (phase 30); K4 on the
    # training slice (phase 11), the --routing pallas step (phase 27) and
    # the mesh steps (phase 30); phase 29 (training) launches none
    for dtype, runs in slice_launches.items():
        for k in ("pool_leaky", "input_stage"):
            runs[k] += d_launches[dtype][k] + art_launches[dtype][k]
    for k in ("pool_leaky", "input_stage"):
        slice_launches["float32"][k] += mesh_launches[k]
    caps_launches["routing"] += (caps_art["routing"] + mesh_launches["routing"]
                                 + scan_launches["routing"])
    train_launches["routing_bwd"] += (routing_launches["routing_bwd"]
                                      + mesh_launches["routing_bwd"]
                                      + scan_launches["routing_bwd"])

    pkg = "cs231_capsule_yolo_traffic_sign_detection_tpu_torch"
    jax_pkg = "cs231_capsule_yolo_traffic_sign_detection_tpu"
    print(json.dumps({"kernels": [
        {"name": "pool_leaky", "route": "cuda",
         "source": f"{pkg}/csrc/pool_leaky.cu",
         "replaces": f"{jax_pkg}/ops/pool_pallas.py:76",
         "launches": launches["pool_leaky"], "max_abs_err": pool_err,
         "ms": k1["ms"], "plain_ms": k1["plain_ms"],
         "bound_ms": k1["bound_ms"], "bound_by": "bytes",
         "library_ms": k1["library_ms"]},
        # K2's f32 kernel (input_stage_tf32x3_kernel: 3xTF32 on mma.sync,
        # bound by bytes), from the f32 slice
        {"name": "input_stage", "route": "cuda",
         "source": f"{pkg}/csrc/input_stage.cu",
         "replaces": f"{jax_pkg}/ops/input_stage.py:177",
         "launches": launches["input_stage"],
         "max_abs_err": is_err[torch.float32],
         "ms": k2["ms"], "plain_ms": k2["plain_ms"],
         "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
         "library_ms": k2["library_ms"]},
        # K2's bf16 kernel (input_stage_mma_kernel), from the bf16 slice
        {"name": "input_stage_bf16", "route": "cuda",
         "source": f"{pkg}/csrc/input_stage.cu",
         "replaces": f"{jax_pkg}/ops/input_stage.py:177",
         "launches": slice_launches["bfloat16"]["input_stage"],
         "max_abs_err": is_err[torch.bfloat16],
         "ms": k2b["ms"], "plain_ms": k2b["plain_ms"],
         "bound_ms": k2b["bound_ms"], "bound_by": k2b["bound_by"],
         "library_ms": k2b["library_ms"]},
        # no one PyTorch call computes dynamic routing: no library_ms
        {"name": "routing", "route": "cuda",
         "source": f"{pkg}/csrc/routing.cu",
         "replaces": f"{jax_pkg}/ops/routing_pallas.py:262",
         "launches": caps_launches["routing"], "max_abs_err": k3_err,
         "ms": k3[False]["ms"], "plain_ms": k3[False]["plain_ms"],
         "bound_ms": k3[False]["bound_ms"],
         "bound_by": k3[False]["bound_by"], "library_ms": None},
        # no one PyTorch call computes the routing VJP: no library_ms
        {"name": "routing_bwd", "route": "cuda",
         "source": f"{pkg}/csrc/routing_bwd.cu",
         "replaces": f"{jax_pkg}/ops/routing_pallas.py:447",
         "launches": train_launches["routing_bwd"], "max_abs_err": k4_err,
         "ms": k4[False]["ms"], "plain_ms": k4[False]["plain_ms"],
         "bound_ms": k4[False]["bound_ms"],
         "bound_by": k4[False]["bound_by"], "library_ms": None},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
