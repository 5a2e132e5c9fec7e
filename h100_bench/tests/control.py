"""The controls and the program's readings on the card, at each cell's
own size, several seeds in one process.

    python3 h100_bench/tests/control.py --cells darknet_r.serve,... \
        --seeds 11,12,13 [--program 0|1] [--control 0|1] [--seconds 2]

For each cell and seed: with ``--program 1`` a run of the cell as the
benchmark runs it (a short window) and its compared numbers; with
``--control 1`` the control's numbers: the plain reference computed in
TF32 (the precision one step below the configurations' float32) put in
the program's place and compared exactly as the program's outputs are.
The limits in limits/<cell>.json lie between the largest program
reading and the smallest control reading (PERF.md gives them).  One
JSON line per reading.
"""

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def control_numbers(cell, seed, device, fault=None):
    """The control's numbers for one cell and seed (a training cell's
    ``fault``: see `EpochTrain.control`)."""
    from h100_bench import harness
    sysmod = harness.system(cell.config["system"])
    if cell.traffic["task"] == "serve":
        return sysmod.serve_control(cell.config, cell.traffic, seed, device)
    job = sysmod.Train(cell.config, cell.traffic, seed, device)
    job.release()
    return job.control(fault)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--program", type=int, default=1)
    ap.add_argument("--control", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--fault", choices=("half",), default=None,
                    help="training cells: the half-batch fault in place "
                         "of the control")
    args = ap.parse_args(argv)
    sys.path[0] = ROOT
    import torch
    from h100_bench import harness
    if not torch.cuda.is_available():
        print("control.py: no CUDA card", file=sys.stderr)
        return 2
    spec = harness.load_spec(ROOT)
    for name in args.cells.split(","):
        cell = harness.Cell(spec, name)
        for seed in (int(s) for s in args.seeds.split(",")):
            if args.program:
                r = harness.run_cell(cell, seed, args.seconds, False, "cuda",
                                     time.time())
                print(json.dumps({"cell": name, "seed": seed,
                                  "side": "program",
                                  "correct": r["correct"],
                                  "checks": r["checks"],
                                  "metrics": r["metrics"]}), flush=True)
            if args.control:
                nums = control_numbers(cell, seed, "cuda", args.fault)
                print(json.dumps({"cell": name, "seed": seed,
                                  "side": args.fault or "control",
                                  "numbers": nums}),
                      flush=True)
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
