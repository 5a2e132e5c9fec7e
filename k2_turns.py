#!/usr/bin/env python3
"""K2 of this tree against K2 of another checkout, timed in turns.

    python3 k2_turns.py OTHER_CHECKOUT [--rounds 2]

Run from the repository root on a machine with a card and nvcc.  Builds
OTHER_CHECKOUT's ``csrc/input_stage.cu`` alone into a library under
``build/k2_turns/`` and this tree's kernels as the port builds them,
checks that the two agree on one input (f32 within rtol 1e-5 and atol
1e-5 of the largest output: the frames are 0-255, so the conv sums
cancel from a few hundred; bf16 within one bf16 ulp), then times both
at darknet_r's shape [32, 448, 448, 3], f32 and bf16, with CUDA events
in turns (other, this, this, other per round), warm and with the L2
flushed before every call.  Then times the end-to-end effect, the
darknet_r f32 serving forward + decode at batch 32 (chip_smoke.py's
seeded detector and scenes), of each tree in its own process, in turns.
Prints the card's name and power limit, then one line per timing.
"""

import argparse
import ctypes
import hashlib
import os
import subprocess
import sys

import torch

import chip_smoke
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.device import (
    resolve_device)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.ops import _build

SHAPE = (chip_smoke.BATCH, 448, 448, 3)
CSRC = os.path.join("cs231_capsule_yolo_traffic_sign_detection_tpu_torch",
                    "csrc")


def build_other(root):
    """OTHER's input_stage.cu as a library with its cyt_input_stage."""
    src = os.path.join(root, CSRC, "input_stage.cu")
    with open(src, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    out_dir = os.path.join(chip_smoke.HERE, "build", "k2_turns")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, f"libk2_{tag}.so")
    if not os.path.exists(lib):
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", src,
                        "-o", lib], check=True)
    return ctypes.CDLL(lib)


def caller(lib, x, w, b):
    """A no-argument call of ``lib``'s K2 on fixed operands."""
    fn = lib.cyt_input_stage
    p = ctypes.c_void_p
    fn.argtypes = [p, p, p, p, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_float, ctypes.c_int, p]
    fn.restype = ctypes.c_int
    bsz, h2, w2, _ = x.shape
    out = torch.empty((bsz, h2 // 2, w2 // 2, 32), dtype=x.dtype,
                      device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        _build.check(fn(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                        out.data_ptr(), bsz, h2, w2, 0.1,
                        _build.DTYPE_CODES[x.dtype], stream), "input_stage")
        return out

    return call


# run in a tree's root, with that tree's chip_smoke.py and package
SERVE = """
import os, sys
sys.path.insert(0, os.getcwd())
import numpy as np, torch
import chip_smoke as cs
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.data import loader
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.device import (
    resolve_device)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.ops import (
    decode, input_stage as ist)
from cs231_capsule_yolo_traffic_sign_detection_tpu_torch.params import Params
resolve_device("cuda")
params = Params(os.path.join("experiments", "darknet_r", "params.json"),
                model="darknet_r", batch_size=cs.BATCH)
_, _, x, _ = loader.synthetic_dataset("darknet_r", params, 0, 64)
frames = np.clip(x * 128.0 + 128, 0, 255).astype(np.uint8)
p = ist.prepare_serving(cs.seeded_darknet(frames).state_dict())
xb = torch.from_numpy(frames[:cs.BATCH]).cuda().float()


def fwd_decode():
    y = ist.darknet_serving_apply(p, xb, n_boxes=1, n_classes=43)
    return decode.decode_grid(y, n_classes=43, n_boxes=1, img_size=448)


with torch.inference_mode():
    print(" ".join(f"{cs.time_ms(fwd_decode, iters=30):.4f}"
                   for _ in range(3)), "ms")
"""


def serving_turns(roots):
    """The f32 serving forward + decode of each tree, in turns."""
    for k in ("other", "this", "this", "other"):
        res = subprocess.run([sys.executable, "-c", SERVE], cwd=roots[k],
                             capture_output=True, text=True, check=True)
        print(f"[turns] darknet_r f32 serving forward+decode batch 32, {k}: "
              f"{res.stdout.strip()}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="root of the other checkout")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    chip_smoke.require(torch.cuda.is_available(), "no CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    resolve_device("cuda")
    libs = {"other": build_other(args.other), "this": _build.library()}
    g = torch.Generator(device="cuda").manual_seed(9)
    x = torch.rand(SHAPE, generator=g, device="cuda") * 255
    w = 0.3 * torch.randn((3, 3, 3, 32), generator=g, device="cuda")
    b = torch.randn((32,), generator=g, device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        xd, wd = x.to(dtype), w.to(dtype).float()
        calls = {k: caller(lib, xd, wd, b) for k, lib in libs.items()}
        got = {k: fn().clone() for k, fn in calls.items()}
        torch.cuda.synchronize()
        scale = got["other"].float().abs().max().item()
        tol = (dict(rtol=1e-5, atol=1e-5 * scale) if dtype == torch.float32
               else dict(rtol=2 ** -6, atol=1e-5))  # each within one ulp
        torch.testing.assert_close(got["this"].float(), got["other"].float(),
                                   **tol)
        name = str(dtype)[6:]
        for r in range(args.rounds):
            for k in ("other", "this", "this", "other"):
                warm = chip_smoke.time_ms(calls[k])
                cold = chip_smoke.time_ms(calls[k], cold=True)
                print(f"[turns] K2 {name} round {r} {k}: warm {warm:.4f} ms,"
                      f" L2 flushed {cold:.4f} ms")
    serving_turns({"other": args.other, "this": chip_smoke.HERE})


if __name__ == "__main__":
    main()
