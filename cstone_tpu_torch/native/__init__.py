"""Host-side C++ oracle on numpy arrays (counterpart of cstone_tpu/native):
Hilbert keys of float32 coordinates and the cornerstone tree of sorted
keys, loaded through ctypes.

The library is compiled from csrc/cstone_host.cpp with g++ at the first
call into cstone_tpu_torch/_build/, under a hash of the source and flags,
and never when the module is imported. It is a test oracle, not a kernel:
no card path calls it. Where g++ is missing or the build fails,
`available()` is False and the functions raise.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading
from typing import Optional

import numpy as np

__all__ = ["hilbert_encode", "compute_octree_host", "available"]

_SRC = pathlib.Path(__file__).resolve().parent / "csrc" / "cstone_host.cpp"
_BUILD_DIR = _SRC.parent.parent.parent / "_build"
_FLAGS = ("-O3", "-std=c++20", "-shared", "-fPIC", "-pthread")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failed = False


def _load() -> Optional[ctypes.CDLL]:
    """The loaded library, built first if its cached build is missing;
    None if g++ is missing or the build or the load fails."""
    global _lib, _failed
    with _lock:
        if _lib is not None or _failed:
            return _lib
        tag = hashlib.sha1(_SRC.read_bytes() + " ".join(_FLAGS).encode()).hexdigest()[:12]
        so = _BUILD_DIR / f"libcstone_host_{tag}.so"
        try:
            if not so.exists():
                _BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = so.with_suffix(f".{os.getpid()}.tmp")
                subprocess.run(["g++", *_FLAGS, "-o", str(tmp), str(_SRC)], check=True, capture_output=True,
                               timeout=300)
                os.replace(tmp, so)
            lib = ctypes.CDLL(str(so))
        except (OSError, subprocess.SubprocessError):
            _failed = True
            return None
        enc = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
        tree = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint32, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
        for name, args, res in (("cst_hilbert_encode_u64", enc, None), ("cst_hilbert_encode_u32", enc, None),
                                ("cst_compute_octree_u64", tree, ctypes.c_int64),
                                ("cst_compute_octree_u32", tree, ctypes.c_int64)):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, res
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the library built and loaded."""
    return _load() is not None


def _lib_or_raise() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("the native host library is unavailable (g++ missing or its build failed)")
    return lib


def hilbert_encode(x: np.ndarray, y: np.ndarray, z: np.ndarray, box_limits, key_dtype=np.uint64) -> np.ndarray:
    """Hilbert keys (uint32 or uint64) of float32 coordinate arrays in the
    box of the 6 limits [xmin, xmax, ymin, ymax, zmin, zmax]."""
    lib = _lib_or_raise()
    x, y, z = (np.ascontiguousarray(a, dtype=np.float32) for a in (x, y, z))
    if not x.shape == y.shape == z.shape or x.ndim != 1:
        raise ValueError(f"x, y, z must be 1-d of one length, got {x.shape}, {y.shape}, {z.shape}")
    lims = np.ascontiguousarray(box_limits, dtype=np.float32)
    if lims.shape != (6,):
        raise ValueError(f"box_limits must hold 6 values, got shape {lims.shape}")
    dt = np.dtype(key_dtype)
    if dt not in (np.dtype(np.uint32), np.dtype(np.uint64)):
        raise TypeError(f"SFC keys must be uint32 or uint64, got {dt}")
    out = np.empty(x.shape[0], dtype=dt)
    fn = lib.cst_hilbert_encode_u64 if dt == np.uint64 else lib.cst_hilbert_encode_u32
    fn(x.ctypes.data, y.ctypes.data, z.ctypes.data, x.shape[0], lims.ctypes.data, out.ctypes.data)
    return out


def compute_octree_host(sorted_codes: np.ndarray, bucket_size: int, capacity: Optional[int] = None):
    """Cornerstone tree of sorted uint32/uint64 keys: (tree_keys
    (n_nodes+1,), counts (n_nodes,) uint32). Raises if the tree needs more
    than `capacity` leaves."""
    lib = _lib_or_raise()
    codes = np.ascontiguousarray(sorted_codes)
    dt = codes.dtype
    if dt not in (np.dtype(np.uint32), np.dtype(np.uint64)) or codes.ndim != 1:
        raise TypeError(f"sorted_codes must be a 1-d uint32 or uint64 array, got {dt} {codes.shape}")
    n = codes.shape[0]
    if capacity is None:
        capacity = max(4096, 3 * n // max(1, bucket_size) + 4096)
    tree = np.empty(capacity + 1, dtype=dt)
    counts = np.empty(capacity, dtype=np.uint32)
    fn = lib.cst_compute_octree_u64 if dt == np.dtype(np.uint64) else lib.cst_compute_octree_u32
    n_nodes = fn(codes.ctypes.data, n, bucket_size, tree.ctypes.data, counts.ctypes.data, capacity)
    if n_nodes < 0:
        raise RuntimeError(f"octree capacity too small, need {-n_nodes}")
    return tree[:n_nodes + 1].copy(), counts[:n_nodes].copy()
