"""27-point cell-list stencil: the hand-written CUDA kernel, its plain
PyTorch versions, and the wrappers that choose between them.

Replaces the Pallas TPU kernel `cstone_tpu/ops/pallas_stencil.py::_kernel_sym`
in both of its main-path variants: op="count" (B1, exact fixed-radius
neighbor counts) and op="density" (B2, unnormalised cubic-spline sums
S_i = sum_{j != i} m_j W(r_ij / h_i)).

Contract (celllist.stencil_neighbor_counts, reference
findneighbors.hpp:96-165): inputs are (n_cells, cap) ELL planes in
row-major cell order of a D^3 grid, D = 2^level. Target slot i counts
candidates j != i of the 27 neighbour cells with d2 < r2_i (count), or
sums m_j W(sqrt(d2) / h_i) (density). Periodic dims wrap and shift the
candidate coordinate by +-L; open dims drop the ghost cells. Self is
excluded by slot identity in the centre cell only, so coincident distinct
particles count each other. Invalid slots give 0.

Both versions compute d2 as ((dx*dx + dy*dy) + dz*dz) in float32 with
every operation rounded on its own (the kernel is compiled with
--fmad=false), so counts agree bit for bit; density sums differ only in
summation order.

Kernel design (csrc/stencil.cu): one CTA per cell, one thread per target
slot, the 27 candidate cells staged through shared memory one at a time;
each thread owns its output, so there are no atomics and results are
deterministic. On the H100 it is bound by FP32 instruction throughput
on the distance tests: about 11 flops per pair and ~8.3e8 candidate pairs
per step at 1M particles, level 5 (mean 30.5 per cell, 27 cells). It evaluates each
unordered pair twice (about 1.9x the symmetric half-stencil of the TPU
kernel); restoring the symmetry with atomics is the first perf step
(ROADMAP.md Queue 2).

CPU tensors take the plain version; CUDA tensors always launch the kernel,
and a build or launch failure raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Optional, Tuple

import torch

__all__ = [
    "stencil_counts",
    "stencil_density",
    "stencil_counts_plain",
    "stencil_density_plain",
    "load_library",
    "launches",
    "reset_launches",
]

_PKG = pathlib.Path(__file__).resolve().parent.parent
_SOURCE = _PKG / "csrc" / "stencil.cu"
_BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# launch counters: one per wrapper, incremented where the kernel launches
stencil_counts_launches = 0
stencil_density_launches = 0

_lib = None
_lib_lock = threading.Lock()
build_log = ""


def launches() -> dict:
    return {"stencil_counts": stencil_counts_launches,
            "stencil_density": stencil_density_launches}


def reset_launches() -> None:
    global stencil_counts_launches, stencil_density_launches
    stencil_counts_launches = 0
    stencil_density_launches = 0


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = pathlib.Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def load_library() -> ctypes.CDLL:
    """Build csrc/stencil.cu with nvcc for sm_90a (once per source
    version, into cstone_tpu_torch/_build/) and load it with ctypes.
    Raises on any build or load failure."""
    global _lib, build_log
    with _lib_lock:
        if _lib is not None:
            return _lib
        src = _SOURCE.read_bytes()
        tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
        so = _BUILD_DIR / f"libcstone_stencil_{tag}.so"
        if not so.exists():
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(_SOURCE)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.cstone_stencil_counts.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, p, p]
        lib.cstone_stencil_counts.restype = i
        lib.cstone_stencil_density.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, p, p]
        lib.cstone_stencil_density.restype = i
        _lib = lib
        return lib


# ----------------------------------------------------------------------------
# argument checks
# ----------------------------------------------------------------------------

def _check(planes, valid, lengths, periodic, level) -> Tuple[int, int]:
    n_cells, cap = planes[0].shape
    if level < 2:
        # D >= 4 keeps the 27 neighbours of a cell distinct under wrap
        raise ValueError(f"stencil needs level >= 2 (a 4^3 grid), got {level}")
    if n_cells != 1 << (3 * level):
        raise ValueError(f"{n_cells} cells do not form a level-{level} grid")
    dev = planes[0].device
    for a in planes:
        if a.shape != (n_cells, cap) or a.dtype != torch.float32 or a.device != dev:
            raise ValueError("ELL planes must be float32 (n_cells, cap) on one device")
    if valid.shape != (n_cells, cap) or valid.dtype != torch.bool or valid.device != dev:
        raise ValueError("valid must be a bool (n_cells, cap) tensor on the planes' device")
    if not all(a.is_contiguous() for a in (*planes, valid)):
        raise ValueError("ELL planes and valid must be contiguous")
    if len(periodic) != 3:
        raise ValueError("periodic must give 3 flags")
    if lengths.shape != (3,):
        raise ValueError("lengths must be a (3,) tensor")
    if dev.type == "cuda" and not 1 <= cap <= 1024:
        raise ValueError(f"the CUDA kernel takes 1 <= cap <= 1024, got {cap}")
    return n_cells, cap


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _lengths(lengths, device) -> torch.Tensor:
    return lengths.to(device=device, dtype=torch.float32).contiguous()


# ----------------------------------------------------------------------------
# public wrappers
# ----------------------------------------------------------------------------

def stencil_counts(px, py, pz, r2, valid, lengths, periodic, level) -> torch.Tensor:
    """(n_cells, cap) int32 neighbor counts #{j != i : d2 < r2_i} (B1)."""
    global stencil_counts_launches
    n_cells, cap = _check((px, py, pz, r2), valid, lengths, periodic, level)
    if px.device.type == "cpu":
        return stencil_counts_plain(px, py, pz, r2, valid, lengths, periodic, level)
    if px.device.type != "cuda":
        raise ValueError(f"unsupported device {px.device}")
    lib = load_library()
    lengths = _lengths(lengths, px.device)
    out = torch.empty((n_cells, cap), dtype=torch.int32, device=px.device)
    stream = torch.cuda.current_stream(px.device).cuda_stream
    err = lib.cstone_stencil_counts(
        _ptr(px), _ptr(py), _ptr(pz), _ptr(r2), _ptr(valid), _ptr(lengths),
        int(periodic[0]), int(periodic[1]), int(periodic[2]), int(level), n_cells, cap,
        _ptr(out), stream)
    if err != 0:
        raise RuntimeError(f"stencil_counts kernel launch failed: cudaError {err}")
    stencil_counts_launches += 1
    return out


def stencil_density(px, py, pz, h, valid, lengths, periodic, level, mass=None) -> torch.Tensor:
    """(n_cells, cap) float32 sums S_i = sum_{j != i} m_j W(r_ij / h_i) (B2);
    m_j = 1 when `mass` is None."""
    global stencil_density_launches
    planes = (px, py, pz, h) + (() if mass is None else (mass,))
    n_cells, cap = _check(planes, valid, lengths, periodic, level)
    if px.device.type == "cpu":
        return stencil_density_plain(px, py, pz, h, valid, lengths, periodic, level, mass)
    if px.device.type != "cuda":
        raise ValueError(f"unsupported device {px.device}")
    lib = load_library()
    lengths = _lengths(lengths, px.device)
    out = torch.empty((n_cells, cap), dtype=torch.float32, device=px.device)
    stream = torch.cuda.current_stream(px.device).cuda_stream
    err = lib.cstone_stencil_density(
        _ptr(px), _ptr(py), _ptr(pz), _ptr(h), _ptr(mass), _ptr(valid), _ptr(lengths),
        int(periodic[0]), int(periodic[1]), int(periodic[2]), int(level), n_cells, cap,
        _ptr(out), stream)
    if err != 0:
        raise RuntimeError(f"stencil_density kernel launch failed: cudaError {err}")
    stencil_density_launches += 1
    return out


# ----------------------------------------------------------------------------
# plain versions: the 27-point roll stencil (celllist.py:356-414)
# ----------------------------------------------------------------------------

def _roll3(a: torch.Tensor, dx: int, dy: int, dz: int) -> torch.Tensor:
    """a is (D, D, D, ...); rolled so cell (i,j,k) sees (i+dx, j+dy, k+dz)."""
    return torch.roll(a, shifts=(-dx, -dy, -dz), dims=(0, 1, 2))


def _neighbour_planes(ex, ey, ez, ev, lengths, periodic, D, dx, dy, dz):
    """Candidate planes of direction (dx, dy, dz): rolled coordinates with
    the +-L wrap shift on periodic dims, validity masked on open dims."""
    cx, cy, cz, cv = (_roll3(a, dx, dy, dz) for a in (ex, ey, ez, ev))
    idx = torch.arange(D, device=ex.device)
    coords = [cx, cy, cz]
    for axis, d in enumerate((dx, dy, dz)):
        if d == 0:
            continue
        over = torch.div(idx + d, D, rounding_mode="floor")  # -1, 0 or +1 at the edges
        shape = [1, 1, 1, 1]
        shape[axis] = D
        over = over.reshape(shape)
        if periodic[axis]:
            coords[axis] = coords[axis] + over.to(torch.float32) * lengths[axis]
        else:
            cv = cv & (over == 0)
    return coords[0], coords[1], coords[2], cv


def _pair_d2(ex, ey, ez, cx, cy, cz):
    ddx = ex[..., :, None] - cx[..., None, :]
    ddy = ey[..., :, None] - cy[..., None, :]
    ddz = ez[..., :, None] - cz[..., None, :]
    return ddx * ddx + ddy * ddy + ddz * ddz


def _directions():
    return [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)]


def stencil_counts_plain(px, py, pz, r2, valid, lengths, periodic, level) -> torch.Tensor:
    """Plain version of stencil_counts: (n_cells, cap) int32."""
    D = 1 << int(level)
    cap = px.shape[1]
    shp = (D, D, D, cap)
    ex, ey, ez, er2 = (a.reshape(shp) for a in (px, py, pz, r2))
    ev = valid.reshape(shp)
    lengths = lengths.to(device=px.device, dtype=torch.float32)
    slot = torch.arange(cap, device=px.device)
    not_self = slot[:, None] != slot[None, :]
    counts = torch.zeros(shp, dtype=torch.int32, device=px.device)
    for dx, dy, dz in _directions():
        cx, cy, cz, cv = _neighbour_planes(ex, ey, ez, ev, lengths, periodic, D, dx, dy, dz)
        d2 = _pair_d2(ex, ey, ez, cx, cy, cz)
        w = (d2 < er2[..., :, None]) & cv[..., None, :] & ev[..., :, None]
        if dx == 0 and dy == 0 and dz == 0:
            w = w & not_self
        counts += w.sum(dim=-1, dtype=torch.int32)
    return counts.reshape(-1, cap)


def cubic_spline_w(q: torch.Tensor) -> torch.Tensor:
    """Unnormalised cubic-spline SPH kernel (models/sph.py contract),
    written in the operation order of the CUDA kernel; q = inf gives 0."""
    w1 = 1.0 - 1.5 * q * q * (1.0 - 0.5 * q)
    t = 2.0 - q
    w2 = 0.25 * (t * t * t)
    return torch.where(q < 1.0, w1, torch.where(q < 2.0, w2, torch.zeros_like(q)))


def stencil_density_plain(px, py, pz, h, valid, lengths, periodic, level, mass=None) -> torch.Tensor:
    """Plain version of stencil_density: (n_cells, cap) float32."""
    D = 1 << int(level)
    cap = px.shape[1]
    shp = (D, D, D, cap)
    ex, ey, ez, eh = (a.reshape(shp) for a in (px, py, pz, h))
    ev = valid.reshape(shp)
    em = None if mass is None else mass.reshape(shp)
    lengths = lengths.to(device=px.device, dtype=torch.float32)
    inv_h = (1.0 / eh)[..., :, None]
    slot = torch.arange(cap, device=px.device)
    not_self = slot[:, None] != slot[None, :]
    total = torch.zeros(shp, dtype=torch.float32, device=px.device)
    for dx, dy, dz in _directions():
        cx, cy, cz, cv = _neighbour_planes(ex, ey, ez, ev, lengths, periodic, D, dx, dy, dz)
        q = torch.sqrt(_pair_d2(ex, ey, ez, cx, cy, cz)) * inv_h
        w = cubic_spline_w(q)
        if em is not None:
            w = w * _roll3(em, dx, dy, dz)[..., None, :]
        m = cv[..., None, :] & ev[..., :, None]
        if dx == 0 and dy == 0 and dz == 0:
            m = m & not_self
        total += torch.where(m, w, torch.zeros_like(w)).sum(dim=-1)
    return total.reshape(-1, cap)
