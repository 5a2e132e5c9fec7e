"""Serving artifacts: trained models as ``torch.export`` programs in
``.pt2`` files (counterpart of the JAX export.py).

An artifact holds the weights as constants and the forward with the
on-device grid decode (and, for the two-stage pipeline, the crops and
the classifier) as one traced program, which a serving process loads
and calls without the checkpoint or the model classes.  The hand
kernels stay in it: K1, K2 and K3 are registered operators
(``torch.ops.cyt.pool_leaky``, ``cyt.input_stage``, ``cyt.routing``;
ops/pool.py, ops/input_stage.py, ops/routing.py), so an f32 or bf16
detector artifact holds one ``cyt::input_stage`` node and four
``cyt::pool_leaky`` nodes, and a capsule artifact under the pallas
routing a ``cyt::routing`` node; loaded on a card each node launches its
kernel, on the CPU it runs the kernel's plain version.  The int8
artifacts hold none (their products are ``torch._int_mm``).

Functions, with the JAX package's names:
  make_detector_fn / make_int8_detector_fn / make_classifier_fn /
  make_grid_fn / make_crops_fn / make_two_stage_fn /
  make_int8_two_stage_fn -- the serving computations (the live predict
    paths call the same functions);
  export_serving        -- a serving fn -> the artifact's bytes, with a
    symbolic batch dimension unless ``batch=`` pins it;
  save / load_serving   -- file round trip; load returns a callable on
    (B, S, S, 3) f32 inputs, on the device it is asked for;
  export_from_checkpoint / export_two_stage_from_checkpoints -- from the
    port's checkpoints;
  selfcheck             -- the artifact against the live fn.

``platforms`` lists the devices an artifact may be loaded on ("cuda",
"cpu"; by default the device it was exported on); `load_serving` on
another device raises, as a JAX artifact called on a platform it was
not exported for does.

Deviations from the JAX package:
  * the artifact needs torch and this package's operator library (the
    ``cyt::*`` registrations, and on a card the kernels csrc/ builds at
    load time, which raises if they do not build); a JAX artifact needs
    only jax;
  * a ``.pt2`` file is not promised to load on another torch version;
  * the classifiers serve in the dtype their module was built in
    (``params.compute_dtype``), not through a separate cast of the
    weights.
"""

import copy
import io

import numpy as np
import torch
from torch.export.passes import move_to_device_pass

from .data.loader import center_rgb
from .device import compute_dtype, resolve_device
from .models import ConvNet
# importing ops.input_stage, ops.pool and ops.routing registers the cyt::*
# operators an artifact's graph calls
from .ops import _build, decode as decode_ops, pool, quant, routing  # noqa
from .ops.crop import crop_resize_bilinear
from .ops.input_stage import darknet_serving_apply, prepare_serving

PLATFORMS = ("cuda", "cpu")
MAX_BATCH = 4095
_PLATFORMS_KEY = "cyt_platforms"


def _decode(y, *, n_boxes, n_classes, img_size, max_boxes=None, conf_th,
            use_nms):
    d = decode_ops.decode_grid(y, n_classes=n_classes, n_boxes=n_boxes,
                               img_size=img_size, max_boxes=max_boxes,
                               conf_th=conf_th)
    if use_nms:
        d = dict(d, valid=decode_ops.nms_mask(d["xy"], d["conf"],
                                              d["valid"]))
    return d


def make_detector_fn(model, *, n_boxes, n_classes, img_size, conf_th=0.5,
                     use_nms=False, dtype=torch.float32):
    """Detection serving fn: x (B, S, S, 3) f32 -> the decode dict.

    The BN-folded serving forward (`darknet_serving_apply`: K2 for block
    1, K1 at the other four pools, in ``dtype``) on ``model``'s weights,
    then the full-width grid decode (every g*g*B candidate) and, with
    ``use_nms``, the greedy NMS."""
    p = prepare_serving(model.state_dict(), dtype)

    def fn(x):
        y = darknet_serving_apply(p, x, n_boxes=n_boxes, n_classes=n_classes,
                                  dtype=dtype)
        return _decode(y, n_boxes=n_boxes, n_classes=n_classes,
                       img_size=img_size, conf_th=conf_th, use_nms=use_nms)

    return fn


def make_classifier_fn(model):
    """Classifier serving fn: x (B, 32, 32, 3) f32 -> (scores f32,
    argmax).  ``model`` (CapsuleNet or ConvNet, put in eval mode) serves
    in its own dtype, CapsuleNet through its routing impl."""
    model.eval()

    def fn(x):
        scores = model(x).float()
        return scores, torch.argmax(scores, dim=-1)

    return fn


def make_int8_detector_fn(qparams, *, n_boxes, n_classes, img_size,
                          conf_th=0.5, use_nms=False):
    """`make_detector_fn`'s contract over the calibrated int8-resident
    chain (`quant.darknet_int8_resident_apply`); the int8 weights, their
    scales and the static activation scales are constants of the
    program."""

    def fn(x):
        y = quant.darknet_int8_resident_apply(qparams, x.float(),
                                              n_boxes=n_boxes,
                                              n_classes=n_classes)
        return _decode(y, n_boxes=n_boxes, n_classes=n_classes,
                       img_size=img_size, conf_th=conf_th, use_nms=use_nms)

    return fn


def make_grid_fn(model):
    """Raw grid forward (darkcapsule, which has no box decode): x ->
    (B, g, g, 5) f32."""
    model.eval()
    return lambda x: model(x).float()


def _make_classify(cls_model, qparams_cls=None):
    """The fused tail's classifier on centered crops: the int8 ConvNet
    chain when ``qparams_cls`` (quant.quantize_convnet) is given, else
    ``cls_model`` in eval mode."""
    if qparams_cls is not None:
        return lambda flat: quant.convnet_int8_apply(qparams_cls, flat)
    cls_model.eval()
    return cls_model


def _crops(x, d, cap_input):
    """The decoded boxes cropped from x, resized to cap_input and
    centered: (B * max_crops, cap_input, cap_input, 3)."""
    crops = crop_resize_bilinear(x, d["xy"], cap_input, valid=d["valid"])
    b, m = crops.shape[:2]
    return center_rgb(crops.reshape(b * m, cap_input, cap_input, -1))


def _two_stage_tail(x, y, *, classify, n_boxes, n_classes, img_size,
                    cap_input, max_crops, conf_th, use_nms, with_grid):
    """Decode -> crop -> classify, the fused two-stage program after its
    detector (one implementation for every detector dtype).  x (B, S, S,
    3) is the detector's input and y its f32 grid; the top ``max_crops``
    boxes of each image by confidence are cropped from x (those at or
    under ``conf_th`` as zeros).  Returns the decode dict with
    ``class_scores`` (B, max_crops, n_cls) f32 and, with ``with_grid``,
    the grid."""
    d = _decode(y, n_boxes=n_boxes, n_classes=n_classes, img_size=img_size,
                max_boxes=max_crops, conf_th=conf_th, use_nms=use_nms)
    scores = classify(_crops(x, d, cap_input)).float()
    out = dict(d, class_scores=scores.reshape(x.shape[0], max_crops, -1))
    if with_grid:
        out["grid"] = y
    return out


def make_crops_fn(det_model, *, n_boxes, n_classes, img_size, cap_input=32,
                  max_crops=16, conf_th=0.5):
    """Detect -> decode -> crop -> center without the classifier: the
    centered crops the fused two-stage feeds its classifier, from
    ``det_model``'s own forward (eval mode).  The int8 ConvNet is
    calibrated on them."""
    det_model.eval()

    def fn(x):
        d = _decode(det_model(x).float(), n_boxes=n_boxes,
                    n_classes=n_classes, img_size=img_size,
                    max_boxes=max_crops, conf_th=conf_th, use_nms=False)
        return _crops(x, d, cap_input)

    return fn


def make_two_stage_fn(det_model, cls_model, *, n_boxes, n_classes, img_size,
                      cap_input=32, max_crops=16, conf_th=0.5, use_nms=False,
                      dtype=torch.float32, with_grid=False):
    """Fused two-stage serving fn: detect -> crop -> classify in one
    program (JAX COMPAT #33).  The detector is `make_detector_fn`'s
    forward in ``dtype`` (K2, K1), the classifier ``cls_model`` in its
    own dtype (K3 for CapsuleNet under the pallas routing).  Crops are
    sampled from the img_size input, not the full-resolution frame, and
    only the top ``max_crops`` boxes are classified, as in the JAX
    package.  For the int8 detector use `make_int8_two_stage_fn`."""
    p = prepare_serving(det_model.state_dict(), dtype)
    tail = dict(classify=_make_classify(cls_model), n_boxes=n_boxes,
                n_classes=n_classes, img_size=img_size, cap_input=cap_input,
                max_crops=max_crops, conf_th=conf_th, use_nms=use_nms,
                with_grid=with_grid)

    def fn(x):
        y = darknet_serving_apply(p, x, n_boxes=n_boxes, n_classes=n_classes,
                                  dtype=dtype)
        return _two_stage_tail(x, y, **tail)

    return fn


def make_int8_two_stage_fn(qparams, cls_model, *, n_boxes, n_classes,
                           img_size, cap_input=32, max_crops=16, conf_th=0.5,
                           use_nms=False, with_grid=False, qparams_cls=None):
    """`make_two_stage_fn` over the int8-resident detector; the
    classifier is the int8 ConvNet chain when ``qparams_cls`` is given,
    else ``cls_model`` in its dtype (CapsuleNet stays f32: no quantized
    routing, JAX COMPAT #35)."""
    tail = dict(classify=_make_classify(cls_model, qparams_cls),
                n_boxes=n_boxes, n_classes=n_classes, img_size=img_size,
                cap_input=cap_input, max_crops=max_crops, conf_th=conf_th,
                use_nms=use_nms, with_grid=with_grid)

    def fn(x):
        y = quant.darknet_int8_resident_apply(qparams, x.float(),
                                              n_boxes=n_boxes,
                                              n_classes=n_classes)
        return _two_stage_tail(x, y, **tail)

    return fn


def make_serving_two_stage_fn(det_model, cls_model, *, dtype, x_cal=None,
                              **common):
    """The fused two-stage fn of a serving dtype, as the live
    ``--device_crop`` path and `export_two_stage_from_checkpoints` build
    it: f32 / bf16 through `make_two_stage_fn`; int8 through
    `make_int8_two_stage_fn`, the detector calibrated on ``x_cal`` (a
    representative (B, S, S, 3) batch) and a ConvNet classifier
    quantized on the crops `make_crops_fn` cuts from it."""
    if dtype != torch.int8:
        return make_two_stage_fn(det_model, cls_model, dtype=dtype, **common)
    qparams = quant.quantize_darknet(det_model.state_dict(), x_cal=x_cal)
    qparams_cls = None
    if isinstance(cls_model, ConvNet):
        crop_keys = ("n_boxes", "n_classes", "img_size", "cap_input",
                     "max_crops", "conf_th")
        crops = make_crops_fn(det_model, **{k: common[k] for k in crop_keys
                                            if k in common})(x_cal)
        qparams_cls = quant.quantize_convnet(cls_model.state_dict(), crops)
    return make_int8_two_stage_fn(qparams, cls_model,
                                  qparams_cls=qparams_cls, **common)


class _Serving(torch.nn.Module):
    """A serving fn as the module torch.export traces; the fn's tensors
    become the program's constants."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x)


def _polymorphism_failure(e):
    msg = str(e).lower()
    return any(word in msg for word in ("constraints violated", "specializ",
                                        "symbolic"))


def export_serving(fn, input_shape, *, batch=None, platforms=None,
                   device="cuda"):
    """A serving fn -> the bytes of its ``.pt2`` artifact.

    ``input_shape`` is the per-example (H, W, C); ``batch`` pins the
    batch dimension, None (the default) exports it symbolic
    (``torch.export.Dim``), so the artifact takes any batch up to
    MAX_BATCH.  When the graph does not admit a symbolic batch the export
    fails with a pointer to ``batch=``; any other failure propagates
    untouched.  The trace runs on ``device`` (the fn's tensors must be
    there) and records ``platforms``, the devices the artifact may be
    loaded on (default: ``device``'s type)."""
    dev = resolve_device(device)
    platforms = tuple(platforms) if platforms else (dev.type,)
    unknown = [p for p in platforms if p not in PLATFORMS]
    if unknown:
        raise ValueError(f"platforms {unknown}: the port's artifacts load "
                         f"on {' | '.join(PLATFORMS)}")
    x = torch.zeros((batch or 2, *input_shape), device=dev)
    # bounded so that batch x max_crops crops stay within 65535 rows, where
    # CUDA's batch norm switches implementation (a guard a trace cannot
    # keep symbolic); 4095 frames is past any serving batch
    dynamic = (None if batch is not None else
               ({0: torch.export.Dim("batch", max=MAX_BATCH)},))
    try:
        with torch.no_grad():
            ep = torch.export.export(_Serving(fn), (x,),
                                     dynamic_shapes=dynamic)
    except Exception as e:
        # only a shape-polymorphism failure earns the "pin batch=" advice;
        # anything else would fail again at a fixed batch
        if batch is None and _polymorphism_failure(e):
            raise ValueError(
                "symbolic-batch export failed for this graph "
                f"({type(e).__name__}: {e}); re-export with an explicit "
                "batch= to pin the batch dimension instead") from e
        raise
    buf = io.BytesIO()
    torch.export.save(ep, buf, extra_files={_PLATFORMS_KEY:
                                            ",".join(platforms)})
    return buf.getvalue()


def save(blob, path):
    with open(path, "wb") as f:
        f.write(blob)
    return path


def _kernel_nodes(ep):
    """The ``cyt::*`` operator nodes of a program's graph, by name."""
    return [str(n.target) for n in ep.graph.nodes
            if n.op == "call_function" and str(n.target).startswith("cyt.")]


def load_serving(path, device="cuda"):
    """Load an artifact onto ``device``; returns ``call(x)`` on (B, S, S,
    3) f32 inputs (numpy or tensors), whose outputs lie on ``device``.

    Raises when ``device`` is not among the artifact's platforms.  On a
    card the kernel library is built (or found built) here, and a build
    that fails raises: a ``cyt::*`` node never runs its plain version on
    a CUDA tensor.  ``call.exported`` is the loaded ExportedProgram and
    ``call.device`` its device."""
    dev = resolve_device(device)
    extra = {_PLATFORMS_KEY: ""}
    ep = torch.export.load(path, extra_files=extra)
    platforms = extra[_PLATFORMS_KEY].split(",")
    if dev.type not in platforms:
        raise ValueError(f"artifact exported for platforms {platforms}; "
                         f"cannot load it on {dev.type!r}")
    if dev.type == "cuda" and _kernel_nodes(ep):
        _build.library()
    ep = move_to_device_pass(ep, dev)
    module = ep.module()

    def call(x):
        x = torch.as_tensor(x, dtype=torch.float32).to(dev).contiguous()
        with torch.inference_mode():
            return module(x)

    call.exported, call.device = ep, dev
    return call


def _input_shape(params):
    """The serving input (H, W, 3) of ``params.model``."""
    if params.model in ("cnn", "capsule"):
        return (32, 32, 3)
    size = int(params.darknet_input)
    if params.model == "darkcapsule":  # the capsule grid needs 32 * n_grid
        size = 32 * int(params.n_grid)
    return (size, size, 3)


def _with_dtype(params, dtype):
    params = copy.copy(params)
    params.compute_dtype = {torch.float32: "float32",
                            torch.bfloat16: "bfloat16",
                            torch.int8: "int8"}[dtype]
    return params


def _check_int8(model_name, x_cal, what="int8 export"):
    """Refuse int8 before any restore: detectors only, x_cal required."""
    if model_name not in ("darknet_d", "darknet_r"):
        raise ValueError(f"{what} is defined for the DarkNet detectors "
                         f"only (got model={model_name!r})")
    if x_cal is None:
        raise ValueError(f"{what} needs a calibration batch: pass x_cal= "
                         "(a representative (B, S, S, 3) input batch)")


def export_from_checkpoint(params, model_dir, restore_file, *, batch=None,
                           conf_th=0.5, use_nms=False, dtype="float32",
                           platforms=None, x_cal=None, device="cuda"):
    """Restore ``params.model``'s checkpoint and export its serving
    artifact on ``device``; returns (blob, the live fn).

    Detectors export `make_detector_fn` (``dtype`` float32 | bfloat16)
    or, with "int8", the int8-resident chain calibrated on ``x_cal`` (a
    representative (B, S, S, 3) batch, required, checked before the
    restore); classifiers `make_classifier_fn` in ``dtype``;
    darkcapsule its raw grid (`make_grid_fn`)."""
    from .predict import restore_model

    dtype = compute_dtype(dtype)
    if dtype == torch.int8:
        _check_int8(params.model, x_cal)
    dev = resolve_device(device)
    shape = _input_shape(params)
    with torch.no_grad():
        model = restore_model(_with_dtype(params, dtype), model_dir,
                              restore_file, dev)
        det = dict(n_boxes=int(params.get("n_boxes", 0)),
                   n_classes=int(params.n_classes), img_size=shape[0],
                   conf_th=conf_th, use_nms=use_nms)
        if dtype == torch.int8:
            qparams = quant.quantize_darknet(
                model.state_dict(),
                x_cal=torch.as_tensor(x_cal, dtype=torch.float32).to(dev))
            fn = make_int8_detector_fn(qparams, **det)
        elif params.model in ("cnn", "capsule"):
            fn = make_classifier_fn(model)
        elif params.model == "darkcapsule":
            fn = make_grid_fn(model)
        else:
            fn = make_detector_fn(model, dtype=dtype, **det)
    return export_serving(fn, shape, batch=batch, platforms=platforms,
                          device=dev), fn


def export_two_stage_from_checkpoints(dark_params, dark_model_dir,
                                      class_params, class_model_dir,
                                      restore_file, *, batch=None,
                                      max_crops=16, conf_th=0.5,
                                      use_nms=False, dtype="float32",
                                      platforms=None, x_cal=None,
                                      device="cuda"):
    """Restore the detector's and the classifier's checkpoints and export
    the fused two-stage pipeline as one artifact, the program the live
    ``--combine ... --device_crop`` path runs
    (`make_serving_two_stage_fn`); returns (blob, the live fn).  bf16
    runs both stages in bf16; int8 the calibrated int8 detector (x_cal
    required, checked before the restores) with the int8 ConvNet, or
    CapsuleNet in f32."""
    from .predict import restore_model

    dtype = compute_dtype(dtype)
    if dtype == torch.int8:
        _check_int8(dark_params.model, x_cal, "int8 two-stage export")
    dev = resolve_device(device)
    shape = _input_shape(dark_params)
    with torch.no_grad():
        det = restore_model(_with_dtype(dark_params, dtype), dark_model_dir,
                            restore_file, dev)
        cls = restore_model(_with_dtype(class_params, dtype),
                            class_model_dir, restore_file, dev)
        if x_cal is not None:
            x_cal = torch.as_tensor(x_cal, dtype=torch.float32).to(dev)
        fn = make_serving_two_stage_fn(
            det, cls, dtype=dtype, x_cal=x_cal,
            n_boxes=int(dark_params.n_boxes),
            n_classes=int(dark_params.n_classes), img_size=shape[0],
            cap_input=int(class_params.get("capsule_input", 32)),
            max_crops=max_crops, conf_th=conf_th, use_nms=use_nms)
    return export_serving(fn, shape, batch=batch, platforms=platforms,
                          device=dev), fn


def _leaves(out):
    """A serving fn's output (a tensor, a tuple, or a dict in key order)
    as a list of tensors."""
    if isinstance(out, dict):
        return [out[k] for k in sorted(out)]
    if isinstance(out, (tuple, list)):
        return list(out)
    return [out]


def selfcheck(call, fn, input_shape, batch=2, seed=0, atol=1e-5):
    """Run the artifact ``call`` (from `load_serving`) and the live
    ``fn`` on the same uniform [0, 1) input on the artifact's device;
    raises AssertionError on a mismatch (rtol 1e-5, ``atol``)."""
    x = np.random.RandomState(seed).rand(batch, *input_shape).astype(
        np.float32)
    got = _leaves(call(x))
    with torch.inference_mode():
        want = _leaves(fn(torch.from_numpy(x).to(call.device)))
    if len(got) != len(want):  # explicit: asserts vanish under python -O
        raise AssertionError(f"artifact returned {len(got)} outputs, the "
                             f"live model {len(want)}")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.float().cpu().numpy(),
                                   w.float().cpu().numpy(), rtol=1e-5,
                                   atol=atol)
    return True
