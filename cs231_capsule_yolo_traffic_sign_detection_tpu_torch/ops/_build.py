"""Build and bind the port's CUDA kernels (``csrc/*.cu``).

``nvcc`` compiles each source for ``sm_90a`` into an object file, all
sources at once in parallel, then links them into one shared library
with a plain C interface under ``build/kernels/`` at the repository
root.  The library's name carries a hash of the sources and flags, so a
changed source rebuilds and an unchanged one is reused.  The build runs
at the first launch of a kernel, never at import: a machine without
``nvcc`` (the CPU tests) imports every module.  A failed build raises.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

import torch

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
SOURCES = ("pool_leaky.cu", "input_stage.cu", "routing.cu",
           "routing_bwd.cu", "fill_shared.cu")
HEADERS = ("common.cuh", "hopper.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

# dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def build_dir():
    pkg_parent = os.path.dirname(os.path.dirname(CSRC))
    return os.path.join(pkg_parent, "build", "kernels")


def _nvcc():
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "cannot be built on this machine")


def _digest():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + f.read())
    return h.hexdigest()[:16]


def build(verbose=False):
    """Compile the kernels if needed; returns the library's path."""
    out_dir = build_dir()
    lib = os.path.join(out_dir, f"libcyt_kernels_{_digest()}.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        procs = []
        for name in SOURCES:
            obj = os.path.join(tmp, name + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", os.path.join(CSRC, name),
                   "-o", obj]
            if verbose:
                cmd[1:1] = ["-Xptxas", "-v"]
            procs.append((obj, cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        objs = []
        for obj, cmd, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{log}")
            if verbose and log:
                print(log, end="")
            objs.append(obj)
        tmp_lib = os.path.join(tmp, "lib.so")
        cmd = [nvcc, "-shared", *NVCC_FLAGS[:2], "-o", tmp_lib, *objs]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({' '.join(cmd)}):\n{res.stdout}"
                f"{res.stderr}")
        os.replace(tmp_lib, lib)
    return lib


@functools.lru_cache(maxsize=None)
def library():
    """The loaded kernel library, built on first use, with argtypes set."""
    lib = ctypes.CDLL(build())
    p, i64, f32, i32 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_float,
                        ctypes.c_int)
    lib.cyt_pool_leaky.argtypes = [p, p, i64, i64, i64, i64, f32, i32, p]
    lib.cyt_pool_leaky.restype = i32
    lib.cyt_input_stage.argtypes = [p, p, p, p, i64, i64, i64, f32, i32, p]
    lib.cyt_input_stage.restype = i32
    lib.cyt_routing.argtypes = [p, p, p, p, p, p, i64, i64, i64, i64, i64,
                                i32, i32, i32, i32, p]
    lib.cyt_routing.restype = i32
    lib.cyt_routing_plan.argtypes = [i64, i64, i64, i32, ctypes.POINTER(i32)]
    lib.cyt_routing_plan.restype = i32
    lib.cyt_routing_bwd.argtypes = [p, p, p, p, p, p, p, p, i64, i64, i64,
                                    i64, i64, i32, i32, i32, p]
    lib.cyt_routing_bwd.restype = i32
    lib.cyt_routing_bwd_plan.argtypes = [i64, i64, i64, i32, i32,
                                         ctypes.POINTER(i32)]
    lib.cyt_routing_bwd_plan.restype = i32
    lib.cyt_fill_shared.argtypes = [f32, p]
    lib.cyt_fill_shared.restype = i32
    return lib


def fill_shared_memory(value=float("nan")):
    """Fill every SM's shared memory with ``value`` on the current stream
    (csrc/fill_shared.cu), so that a kernel launched next that reads
    shared memory it never wrote reads ``value``.  A test aid."""
    check(library().cyt_fill_shared(
        value, torch.cuda.current_stream().cuda_stream), "fill_shared")


def check(err, name):
    """Raise when a launch returned a non-zero cudaGetLastError()."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")
