#!/usr/bin/env python3
"""K2 of this tree against K2 of another checkout, timed in turns.

    python3 k2_turns.py OTHER_CHECKOUT [--rounds 2]

Run from the repository root on a machine with a card and nvcc.  Builds
OTHER_CHECKOUT's ``csrc/input_stage.cu`` alone into a library under
``build/k2_turns/`` and this tree's kernels as the port builds them,
checks that the two agree on one input (f32 within 1e-5, bf16 within
one bf16 ulp), then times both at darknet_r's shape [32, 448, 448, 3],
f32 and bf16, with CUDA events in turns (other, this, this, other per
round), warm and with the L2 flushed before every call.  Prints the
card's name and power limit, then one line per timing.
"""

import argparse
import ctypes
import hashlib
import os
import subprocess

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
        tol = (dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 else
               dict(rtol=2 ** -6, atol=1e-5))  # each within one ulp
        torch.testing.assert_close(got["this"].float(), got["other"].float(),
                                   **tol)
        name = str(dtype)[6:]
        for r in range(args.rounds):
            for k in ("other", "this", "this", "other"):
                warm = chip_smoke.time_ms(calls[k])
                cold = chip_smoke.time_ms(calls[k], cold=True)
                print(f"[turns] K2 {name} round {r} {k}: warm {warm:.4f} ms,"
                      f" L2 flushed {cold:.4f} ms")


if __name__ == "__main__":
    main()
