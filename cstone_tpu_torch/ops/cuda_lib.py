"""Build and load the port's hand-written CUDA kernels.

Each source in `cstone_tpu_torch/csrc/` is compiled on first use with
nvcc for sm_90a into a shared library with a plain C interface, cached in
`cstone_tpu_torch/_build/` under a hash of the source and flags, and
loaded with ctypes. Nothing here runs at import time: the CPU tests import
every module, and the CPU has no nvcc. Any build or load failure raises.

Sources build independently, so a caller may build several at once from
threads (nvcc runs in a subprocess and releases the GIL).

`LaunchCounts` counts each wrapper's launches (utils/trace.Counts), and
`record_launches()` lets a check hold each kernel against its plain
version on exactly the arguments a path launched it with. Both take a
lock: ranks that run as threads of one process (parallel/comm.run_ranks)
launch at once.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Callable, Optional

import torch

from ..utils.trace import Counts

__all__ = ["NVCC_FLAGS", "CudaLibrary", "nvcc_path", "ptr", "stream_of", "check_launch",
           "LaunchCounts", "record_launches"]

_PKG = pathlib.Path(__file__).resolve().parent.parent
_BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


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
    """

    def __init__(self, source: str, bind: Callable[[ctypes.CDLL], None]):
        self.source = _PKG / "csrc" / source
        self._bind = bind
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()
        self.build_log = ""

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
