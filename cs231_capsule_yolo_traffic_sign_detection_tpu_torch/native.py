"""Build-on-first-use of the port's C++ host libraries (csrc/*.cpp):
the confusion sweep (metrics/_native.py) and the streaming prefetcher
(data/stream.py), counterpart of the JAX package's native_util.py.

Each source is compiled with g++ at its first use into ``build/native/``
at the repository root (gitignored); the library's name carries a hash
of the source and flags, so a changed source rebuilds.  A failed build
raises: unlike the JAX package, which returns None and falls back to
numpy in silence, the port hides no fallback (the numpy paths are asked
for by name, ``use_native=False``).
"""

import hashlib
import os
import subprocess
import tempfile

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
# no -march=native and no FMA contraction: results are then the same
# IEEE expressions as the numpy paths' on every machine
FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-ffp-contract=off")


def build_dir():
    return os.path.join(os.path.dirname(os.path.dirname(CSRC)), "build",
                        "native")


def build(source_name, stem, flags=FLAGS):
    """Compile csrc/<source_name> into build/native/<stem>_<hash>.so if
    it is not there yet; returns the library path."""
    source = os.path.join(CSRC, source_name)
    with open(source, "rb") as f:
        digest = hashlib.sha256(" ".join(flags).encode() + f.read())
    out_dir = build_dir()
    lib = os.path.join(out_dir, f"{stem}_{digest.hexdigest()[:16]}.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(out_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        tmp_lib = os.path.join(tmp, "lib.so")
        cmd = ["g++", *flags, "-o", tmp_lib, source]
        try:
            res = subprocess.run(cmd, capture_output=True, text=True)
        except FileNotFoundError:
            raise RuntimeError(f"g++ not found: {source_name} cannot be "
                               "built") from None
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed ({' '.join(cmd)}):\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(tmp_lib, lib)   # atomic: concurrent builds agree
    return lib
