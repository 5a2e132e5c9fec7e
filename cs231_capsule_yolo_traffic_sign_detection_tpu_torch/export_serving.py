"""Export a trained model of the port as a serving artifact (``.pt2``).

    python -m \\
        cs231_capsule_yolo_traffic_sign_detection_tpu_torch.export_serving \\
        --model darknet_r --restore best [--model_dir DIR] \\
        [--out artifact.pt2] [--batch 32] [--dtype bfloat16|int8] \\
        [--calib x.npy] [--conf_th 0.5] [--combine cnn|capsule] \\
        [--max_crops 16] [--nms] [--platforms cuda,cpu] \\
        [--train_frac 1] [--device cuda|cpu]

The artifact holds the weights and the forward with the on-device grid
decode (with --combine, the fused detect -> crop -> classify pipeline)
as one traced program; a serving process loads it with torch and this
package's operator library:

    from cs231_capsule_yolo_traffic_sign_detection_tpu_torch import export
    serve = export.load_serving("artifact.pt2", device="cuda")
    out = serve(images)        # (B, S, S, 3) float32

The batch dimension is symbolic unless --batch pins it.  --dtype int8
(detectors) calibrates the static activation scales on the first test
batch, as predict does (the synthetic set when the data is absent), or
on --calib.  The artifact is checked against the live model before the
command exits.  The counterpart of the JAX package's
scripts/export_serving.py, with --device in place of --cpu.
"""

import argparse
import os

import numpy as np
import torch

from . import __main__ as cli, config, export
from .device import compute_dtype, resolve_device
from .ops.preprocess import preprocess_images


def _load_params(model, args):
    """The CLI's params for ``model`` (its params.json with the CLI's
    defaults and these overrides)."""
    ns = cli.parser.parse_args(["--model", model, "--mode", "predict",
                                "--dtype", args.dtype,
                                "--train_frac", str(args.train_frac),
                                "--device", args.device])
    model_dir = (args.model_dir if model == args.model and args.model_dir
                 else config.model_dir[model])
    return cli.load_params(model_dir, ns, model), model_dir


def _calibration_batch(args, params, dev):
    """--calib's batch, else the first batch of the test frames as the
    detector sees them (predict's calibration source)."""
    if args.calib:
        return torch.from_numpy(np.load(args.calib).astype(np.float32))
    frames, _ = cli.load_test_frames(config.data_dir[args.model], args.model,
                                     params)
    return preprocess_images(frames[:int(params.batch_size)],
                             int(params.darknet_input), dev)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m cs231_capsule_yolo_traffic_sign_detection_tpu_torch"
        ".export_serving", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model", required=True, help=" | ".join(
        config.model_names))
    ap.add_argument("--restore", default="best", help="last | best")
    ap.add_argument("--model_dir", default=None)
    ap.add_argument("--out", default=None,
                    help="output path (default <model_dir>/serving.pt2)")
    ap.add_argument("--batch", type=int, default=None,
                    help="pin the batch dim (default: symbolic)")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "f32", "bfloat16", "bf16", "int8"])
    ap.add_argument("--calib", default=None,
                    help="int8: .npy of a representative (B, S, S, 3) "
                    "calibration batch (default: the first test batch)")
    ap.add_argument("--conf_th", type=float, default=0.5)
    ap.add_argument("--combine", default=None, choices=["cnn", "capsule"],
                    help="export the fused two-stage pipeline")
    ap.add_argument("--max_crops", type=int, default=16,
                    help="--combine: boxes classified per frame")
    ap.add_argument("--nms", action="store_true",
                    help="the greedy NMS in the artifact")
    ap.add_argument("--platforms", default=None,
                    help="comma list of cuda, cpu (default: --device)")
    ap.add_argument("--train_frac", type=float, default=1)
    ap.add_argument("--device", default="cuda", help="cuda | cpu")
    args = ap.parse_args(argv)
    if args.model not in config.model_names:
        ap.error(f"--model {args.model}: " + " | ".join(config.model_names))
    if args.combine and args.model not in cli.DETECTORS:
        ap.error("--combine exports the two-stage pipeline of the DarkNet "
                 "detectors only")

    dev = resolve_device(args.device)
    params, model_dir = _load_params(args.model, args)
    platforms = args.platforms.split(",") if args.platforms else None
    x_cal = None
    if compute_dtype(args.dtype) == torch.int8 and args.model in cli.DETECTORS:
        x_cal = _calibration_batch(args, params, dev)
        print(f"[export] int8 calibration batch: {tuple(x_cal.shape)}")
    common = dict(batch=args.batch, conf_th=args.conf_th, use_nms=args.nms,
                  dtype=args.dtype, platforms=platforms, x_cal=x_cal,
                  device=dev)
    if args.combine:
        cls_params, cls_dir = _load_params(args.combine, args)
        blob, fn = export.export_two_stage_from_checkpoints(
            params, model_dir, cls_params, cls_dir, args.restore,
            max_crops=args.max_crops, **common)
    else:
        blob, fn = export.export_from_checkpoint(params, model_dir,
                                                 args.restore, **common)

    out = args.out or os.path.join(model_dir, "serving.pt2")
    export.save(blob, out)
    print(f"[export] wrote {out} ({len(blob) / 1e6:.1f} MB)")
    serve = export.load_serving(out, device=dev)
    export.selfcheck(serve, fn, export._input_shape(params),
                     batch=args.batch or 2)
    print("[export] self-check passed (artifact == live model)")


if __name__ == "__main__":
    main()
