"""Host-streaming batch pipeline for ``--stream`` (counterpart of the JAX
data/stream.py and native/prefetch.cpp).

The train driver keeps a dataset resident on the device by default; one
larger than device memory streams from host memory or disk instead.
Batches are assembled ahead of the consumer by the C++ ring-buffer
prefetcher (csrc/prefetch.cpp, built with g++ at first use by
`native.build`: worker threads gather permuted rows while Python waits
on the device).  A failed build raises; the byte-identical numpy path
runs only when the caller asks for it (``use_native=False``).

Semantics are the driver's (shuffle + np.array_split, reference
main.py:45-48): given the same permutation, `iter_batches` yields
exactly ``np.array_split(x[perm], n_batch)`` / ``np.array_split(y[perm],
n_batch)`` with the X rows as float32.  X may be stored uint8 (raw
pixels): the prefetcher fuses the loader's `center_rgb`
((v - 128) / 128) into the gather, so raw-pixel stores stream at a
quarter of the float32 footprint.  Memmapped .npy artifacts
(`open_memmap_dataset`) work unchanged: the worker threads fault their
pages in.  Under a mesh each rank loads only its rows of every batch
(`iter_batches_process_local`).
"""

import ctypes
import functools

import numpy as np

from .. import config, native

RING, THREADS = 3, 2  # the prefetcher's batch slots and worker threads


@functools.lru_cache(maxsize=None)
def library():
    """The prefetcher library, built on first use, with argtypes set."""
    lib = ctypes.CDLL(native.build("prefetch.cpp", "libprefetch",
                                   native.FLAGS + ("-pthread",)))
    i64 = ctypes.c_int64
    lp = ctypes.POINTER(i64)
    lib.pf_create.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                              i64, i64, lp, lp, i64, ctypes.c_int,
                              ctypes.c_int]
    lib.pf_create.restype = ctypes.c_void_p
    lib.pf_acquire.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.c_void_p)]
    lib.pf_acquire.restype = i64
    lib.pf_release.argtypes = [ctypes.c_void_p]
    lib.pf_release.restype = None
    lib.pf_destroy.argtypes = [ctypes.c_void_p]
    lib.pf_destroy.restype = None
    return lib


def batch_offsets(n, n_batch):
    """np.array_split boundaries: n_batch parts, larger splits first."""
    sizes = [len(s) for s in np.array_split(np.arange(n), n_batch)]
    return np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)


def center_rgb(rows):
    """uint8 pixels -> centered float32, (v - 128) / 128 in float32: the
    prefetcher's fused conversion (and the loader's `center_rgb` of the
    same pixels, rounded to float32)."""
    return (rows.astype(np.float32) - np.float32(128.0)) / np.float32(128.0)


def _normalize_x(rows):
    if rows.dtype == np.uint8:
        return center_rgb(rows)
    return rows.astype(np.float32)


def _iter_numpy(x, y, perm, offsets):
    for lo, hi in zip(offsets[:-1], offsets[1:]):
        idx = perm[lo:hi]
        yield _normalize_x(x[idx]), y[idx].copy()


def iter_batches(x, y, perm, n_batch, copy=True, use_native=True):
    """Yield (x_f32, y) batches of x[perm]/y[perm] split n_batch ways.

    The native threaded prefetcher by default (X float32 or uint8); the
    numpy generator with ``use_native=False``.  With ``copy=False`` the
    native path yields zero-copy views into the ring slot, valid only
    until the next iteration: callers consume (copy) each batch before
    advancing.
    """
    perm = np.ascontiguousarray(perm, dtype=np.int64)
    if perm.shape[0] == 0:
        return
    offsets = batch_offsets(perm.shape[0], n_batch)
    yield from _iter_offsets(x, y, perm, offsets, copy, use_native)


def iter_batches_process_local(x, y, perm, n_batch, process_index=None,
                               process_count=None, copy=True,
                               shard_rows=None, row_slices=None,
                               use_native=True):
    """Mesh streaming: this rank's rows of each global batch.

    The global batch b is perm[off[b]:off[b+1]]; the prefetcher gathers
    only the within-batch rows ``row_slices(n_global)`` names (a list of
    (lo, hi); `parallel.mesh.process_row_slices`), by default an equal
    contiguous split over the ranks (`parallel.mesh.
    process_batch_slice`).  A batch whose size is not a multiple of
    ``shard_rows`` (the mesh's data axis) is replicated by the consumer
    (`parallel.mesh.place_batch`'s ragged-tail rule), so it is yielded in
    full.  Yields (x_local_f32, y_local, n_global_rows).
    """
    from ..parallel.mesh import process_batch_slice

    perm = np.ascontiguousarray(perm, dtype=np.int64)
    if perm.shape[0] == 0:
        return
    offsets = batch_offsets(perm.shape[0], n_batch)
    sub, sub_off, globals_ = [], [0], []
    for lo, hi in zip(offsets[:-1], offsets[1:]):
        n_glob = int(hi - lo)
        if shard_rows is not None and n_glob % int(shard_rows) != 0:
            parts = [(0, n_glob)]  # ragged tail: full rows everywhere
        elif row_slices is not None:
            parts = [(int(s), int(e)) for s, e in row_slices(n_glob)]
        else:
            parts = [process_batch_slice(n_glob, process_index,
                                         process_count)]
        n_loc = 0
        for s, e in parts:
            sub.append(perm[lo + s: lo + e])
            n_loc += e - s
        sub_off.append(sub_off[-1] + n_loc)
        globals_.append(n_glob)
    sub_perm = (np.concatenate(sub) if sub
                else np.zeros(0, np.int64)).astype(np.int64)
    sub_off = np.asarray(sub_off, np.int64)
    for (xb, yb), n_glob in zip(
            _iter_offsets(x, y, sub_perm, sub_off, copy, use_native),
            globals_):
        yield xb, yb, n_glob


def _iter_offsets(x, y, perm, offsets, copy, use_native):
    if not use_native:
        yield from _iter_numpy(x, y, perm, offsets)
        return
    if x.dtype not in (np.float32, np.uint8):
        raise ValueError(f"the prefetcher takes float32 or uint8 rows, not "
                         f"{x.dtype}")
    lib = library()
    x = x if _is_contiguous(x) else np.ascontiguousarray(x)
    y = y if _is_contiguous(y) else np.ascontiguousarray(y)
    x_row_elems = int(np.prod(x.shape[1:], dtype=np.int64))
    y_row_bytes = int(np.prod(y.shape[1:], dtype=np.int64)) * y.dtype.itemsize
    h = lib.pf_create(
        ctypes.c_void_p(x.ctypes.data), ctypes.c_void_p(y.ctypes.data),
        int(x.dtype == np.uint8), x_row_elems, y_row_bytes,
        perm.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        int(len(offsets) - 1), RING, THREADS)
    if not h:
        raise MemoryError("the prefetcher could not allocate its ring")
    try:
        xp = ctypes.POINTER(ctypes.c_float)()
        yp = ctypes.c_void_p()
        while True:
            rows = lib.pf_acquire(h, ctypes.byref(xp), ctypes.byref(yp))
            if rows < 0:
                break
            if rows == 0:  # np.array_split emits empties when n_batch > n
                lib.pf_release(h)
                yield (np.zeros((0,) + x.shape[1:], np.float32),
                       np.zeros((0,) + y.shape[1:], y.dtype))
                continue
            xb = np.ctypeslib.as_array(xp, shape=(int(rows),) + x.shape[1:])
            yb = np.frombuffer(
                ctypes.cast(yp, ctypes.POINTER(
                    ctypes.c_uint8 * (int(rows) * y_row_bytes))).contents,
                dtype=y.dtype).reshape((int(rows),) + y.shape[1:])
            if copy:
                # copies taken: free the ring slot before yielding, so
                # the workers refill it while the consumer runs its step
                xb, yb = xb.copy(), yb.copy()
                lib.pf_release(h)
                yield xb, yb
            else:
                yield xb, yb   # views: the slot stays locked until next
                lib.pf_release(h)
    finally:
        lib.pf_destroy(h)


def _is_contiguous(a):
    return isinstance(a, np.ndarray) and a.flags["C_CONTIGUOUS"]


def open_memmap_dataset(data_dir, split="train"):
    """Memmap a split's npy artifacts (X stays on disk until faulted):
    ``<data_dir>/<split>_X.npy`` and ``_Y.npy`` (build_data_npy.py's
    names)."""
    stem = {"train": config.tr_d, "eval": config.ev_d,
            "test": "/test.p"}[split]
    stem = stem[:-2] if stem.endswith(".p") else stem
    x = np.load(data_dir + stem + "_X.npy", mmap_mode="r")
    y = np.load(data_dir + stem + "_Y.npy", mmap_mode="r")
    return x, y
