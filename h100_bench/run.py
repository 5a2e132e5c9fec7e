"""Run one cell of the port's H100 benchmark once.

    python3 h100_bench/run.py --workload <name> --seed <n> --seconds <s>
                              --trace <0|1>

from the root of a checkout.  Prints the result as one JSON line, the
last of standard output, and each number compared beside its limit as
the last lines of standard error.  Exits non-zero, with no result, when
there is no card (or fewer than the cell asks for), when the port is
absent, or when JAX or the JAX package was loaded.
"""

import argparse
import json
import os
import sys
import time


def process_start():
    """The epoch second this process started (Linux /proc), so set-up
    counts the interpreter's start and the imports."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(line.split()[1]) for line in f
                        if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


T_START = process_start()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "build", "h100_bench_cache")


def cache_env():
    """Every kernel and build cache at a fixed path inside the checkout
    (the port's own nvcc build already lives in build/kernels/)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(CACHE, sub)
    os.environ["USE_FLAX"] = "0"


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    cache_env()
    # the checkout's root, not this folder, is where names resolve
    sys.path[0] = ROOT
    import torch
    from h100_bench import harness

    if not torch.cuda.is_available():
        print("h100_bench: no CUDA card (torch.cuda.is_available() is "
              "False); the benchmark measures the card only",
              file=sys.stderr)
        return 2
    cell = harness.Cell(harness.load_spec(ROOT), args.workload)
    if torch.cuda.device_count() < cell.chips:
        print(f"h100_bench: {args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), "cuda", T_START)
    found = harness.jax_modules()
    if found:
        print(f"h100_bench: loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
