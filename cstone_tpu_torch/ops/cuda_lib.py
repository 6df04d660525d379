"""Build and load the port's hand-written CUDA kernels.

Each source in `cstone_tpu_torch/csrc/` is compiled on first use with
nvcc for sm_90a into a shared library with a plain C interface, cached in
`cstone_tpu_torch/_build/` under a hash of the source and flags, and
loaded with ctypes. Nothing here runs at import time: the CPU tests import
every module, and the CPU has no nvcc. Any build or load failure raises.

Sources build independently, so a caller may build several at once from
threads (nvcc runs in a subprocess and releases the GIL).

This module is also the one registry of the port's kernels: each
CudaLibrary enters itself when made, and each kernel module enters its
LaunchCounts and the plain versions of its wrappers (register_launches).
`libraries()`, `all_launches()`, `reset_all_launches()` and `plain_of()`
read the registry after importing every module of this package, so a new
kernel needs its module and its source, and no list anywhere else.

`LaunchCounts` counts each wrapper's launches (utils/trace.Counts), and
`record_launches()` lets a check hold each kernel against its plain
version on exactly the arguments a path launched it with. Both take a
lock: ranks that run as threads of one process (parallel/comm.run_ranks)
launch at once.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import importlib
import os
import pathlib
import pkgutil
import shutil
import subprocess
import threading
from typing import Callable, Optional

import torch

from ..utils.trace import Counts

__all__ = ["NVCC_FLAGS", "CudaLibrary", "nvcc_path", "ptr", "stream_of", "check_launch",
           "LaunchCounts", "record_launches", "register_launches", "libraries", "all_launches",
           "reset_all_launches", "plain_of"]

_PKG = pathlib.Path(__file__).resolve().parent.parent
_BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# the registry, filled as the kernel modules are imported
_LIBRARIES: list = []  # every CudaLibrary
_COUNTS: list = []  # (key prefix, LaunchCounts) of every kernel module
_PLAIN: dict = {}  # recorded wrapper name -> its plain version


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = pathlib.Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


class CudaLibrary:
    """One csrc/*.cu source, built at the first `load()`.

    `bind(lib)` sets the argtypes/restype of the library's C entry points.
    `build_log` holds nvcc's output (ptxas' register report) after a build.
    Each is entered in the registry (`libraries()`) when made.
    """

    def __init__(self, source: str, bind: Callable[[ctypes.CDLL], None]):
        self.source = _PKG / "csrc" / source
        self._bind = bind
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()
        self.build_log = ""
        _LIBRARIES.append(self)

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is not None:
                return self._lib
            src = self.source.read_bytes()
            tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
            so = _BUILD_DIR / f"lib{self.source.stem}_{tag}.so"
            if not so.exists():
                _BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = so.with_suffix(f".{os.getpid()}.tmp")
                cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
                proc = subprocess.run(cmd, capture_output=True, text=True)
                self.build_log = proc.stdout + proc.stderr
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed on {self.source.name} "
                                       f"({proc.returncode}):\n{self.build_log}")
                os.replace(tmp, so)
            lib = ctypes.CDLL(str(so))
            self._bind(lib)
            self._lib = lib
            return lib


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check_launch(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


_recorded: Optional[list] = None
_recorded_lock = threading.Lock()


@contextlib.contextmanager
def record_launches():
    """Inside the block, every kernel wrapper that launches appends
    (wrapper name, its arguments, its result) to the yielded list, from
    whichever thread it launches."""
    global _recorded
    with _recorded_lock:
        prev, _recorded = _recorded, []
        calls = _recorded
    try:
        yield calls
    finally:
        with _recorded_lock:
            _recorded = prev


class LaunchCounts(Counts):
    """One module's launch count per kernel wrapper."""

    def launched(self, name: str, args: tuple, out) -> None:
        """Count one launch of `name` and record it for record_launches()."""
        self.add(name)
        with _recorded_lock:
            if _recorded is not None:
                _recorded.append((name, args, out))


def register_launches(counts: LaunchCounts, prefix: str = "", plain: Optional[dict] = None) -> None:
    """Enter a kernel module's launch counts in the registry: all_launches()
    reports each of its names with `prefix` before it. `plain` maps each
    wrapper that records its launches (LaunchCounts.launched) to its plain
    version, which takes the same arguments and returns the same result."""
    _COUNTS.append((prefix, counts))
    _PLAIN.update(plain or {})


@functools.cache
def _import_kernel_modules() -> None:
    """Import every module of this package, so that each kernel module has
    entered its library and its counts in the registry."""
    for info in pkgutil.iter_modules([str(pathlib.Path(__file__).parent)]):
        importlib.import_module(f"{__package__}.{info.name}")


def libraries(*sources: str) -> tuple:
    """The registered CudaLibrary of each csrc source named (KeyError for a
    source that has none), or with no names every one, by source name."""
    _import_kernel_modules()
    if not sources:
        return tuple(sorted(_LIBRARIES, key=lambda lib: lib.source.name))
    by_source = {lib.source.name: lib for lib in _LIBRARIES}
    return tuple(by_source[s] for s in sources)


def all_launches() -> dict:
    """Every kernel wrapper's launch count, by its prefixed name."""
    _import_kernel_modules()
    return dict(sorted((prefix + name, n) for prefix, counts in _COUNTS
                       for name, n in counts.snapshot().items()))


def reset_all_launches() -> None:
    _import_kernel_modules()
    for _, counts in _COUNTS:
        counts.reset()


def plain_of(name: str) -> Callable:
    """The plain version of the recorded wrapper `name` (KeyError for a
    wrapper whose launches are not replayed)."""
    _import_kernel_modules()
    return _PLAIN[name]
