"""27-point cell-list stencil: the hand-written CUDA kernel, its plain
PyTorch versions, and the wrappers that choose between them.

Replaces the Pallas TPU kernels of `cstone_tpu/ops/pallas_stencil.py`:

  B1  `_kernel_sym` op="count" (:295)     -> stencil_counts
  B2  `_kernel_sym` op="density" (:295)   -> stencil_density
  B3  `_kernel_sym` cross=True (:589)     -> stencil_cross
  B4  `_kernel` (:149), impl="pallas_asym" -> stencil_counts_asym

Contract (celllist.stencil_neighbor_counts, reference
findneighbors.hpp:96-165): inputs are (n_cells, cap) ELL planes in
row-major cell order of a D^3 grid, D = 2^level; valid slots form a prefix
of each row (ell_pack builds them so). Target slot i counts candidates j
of the 27 neighbour cells with d2 < r2_i (count), or sums
m_j W(sqrt(d2) / h_i) (density). Periodic dims wrap and shift the
candidate coordinate by +-L; open dims drop the ghost cells. B1/B2 exclude
self by slot identity in the centre cell only, so coincident distinct
particles count each other; B3 runs between two disjoint sets (target and
candidate tables with their own caps) with no self mask, once from each
end; B4 counts the self pair and subtracts it afterwards, the JAX
one-sided kernel's contract. Invalid slots give 0.

All versions compute d2 as ((dx*dx + dy*dy) + dz*dz) in float32 with
every operation rounded on its own (the kernel is compiled with
--fmad=false), from the target's end, so counts agree bit for bit; density
sums differ only in summation order.

Kernel design (csrc/stencil.cu): a fixed block of up to 256 threads per
(cell, chunk of target slots), one thread per target slot, each candidate
cell staged through shared memory in chunks of the block size; no atomics,
deterministic results, any cap. On the H100 it is bound by FP32
instruction issue on the distance tests, about 11 flops per pair. It
evaluates each unordered pair twice (the TPU kernel's symmetric
half-stencil once); restoring the symmetry with atomics is a later perf
step (ROADMAP.md Queue 2).

CPU tensors take the plain version; CUDA tensors always launch the kernel,
and a build or launch failure raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .cuda_lib import CudaLibrary, check_launch, note_launch, ptr, stream_of

__all__ = [
    "stencil_counts",
    "stencil_density",
    "stencil_cross",
    "stencil_counts_asym",
    "stencil_counts_plain",
    "stencil_density_plain",
    "stencil_cross_plain",
    "stencil_counts_asym_plain",
    "load_library",
    "launches",
    "reset_launches",
]


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.cstone_stencil.argtypes = [i, p, p, p, p, p, i, p, p, p, p, p, i, p, i, i, i, i, i, p, p]
    lib.cstone_stencil.restype = i


LIBRARY = CudaLibrary("stencil.cu", _bind)

# launch counters: one per wrapper, incremented where the kernel launches
stencil_counts_launches = 0
stencil_density_launches = 0
stencil_cross_launches = 0
stencil_asym_launches = 0


def load_library() -> ctypes.CDLL:
    """Build csrc/stencil.cu (once per source version) and load it."""
    return LIBRARY.load()


def launches() -> dict:
    return {"stencil_counts": stencil_counts_launches,
            "stencil_density": stencil_density_launches,
            "stencil_cross": stencil_cross_launches,
            "stencil_counts_asym": stencil_asym_launches}


def reset_launches() -> None:
    global stencil_counts_launches, stencil_density_launches
    global stencil_cross_launches, stencil_asym_launches
    stencil_counts_launches = 0
    stencil_density_launches = 0
    stencil_cross_launches = 0
    stencil_asym_launches = 0


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
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return n_cells, cap


def _launch(density: bool, tgt, cand, lengths, periodic, level, self_mask: bool) -> torch.Tensor:
    """One kernel launch. tgt = (x, y, z, r2 or h, valid); cand = (x, y,
    z, mass or None, valid)."""
    tx, ty, tz, tw, tvalid = tgt
    cx, cy, cz, cw, cvalid = cand
    dev = tx.device
    lib = load_library()
    lengths = lengths.to(device=dev, dtype=torch.float32).contiguous()
    out = torch.empty(tx.shape, dtype=torch.float32 if density else torch.int32, device=dev)
    err = lib.cstone_stencil(
        int(density), ptr(tx), ptr(ty), ptr(tz), ptr(tw), ptr(tvalid), tx.shape[1],
        ptr(cx), ptr(cy), ptr(cz), ptr(cw), ptr(cvalid), cx.shape[1], ptr(lengths),
        int(periodic[0]), int(periodic[1]), int(periodic[2]), int(level), int(self_mask),
        ptr(out), stream_of(tx))
    check_launch(err, "stencil")
    return out


# ----------------------------------------------------------------------------
# public wrappers
# ----------------------------------------------------------------------------

def stencil_counts(px, py, pz, r2, valid, lengths, periodic, level) -> torch.Tensor:
    """(n_cells, cap) int32 neighbor counts #{j != i : d2 < r2_i} (B1)."""
    global stencil_counts_launches
    _check((px, py, pz, r2), valid, lengths, periodic, level)
    if px.device.type == "cpu":
        return stencil_counts_plain(px, py, pz, r2, valid, lengths, periodic, level)
    out = _launch(False, (px, py, pz, r2, valid), (px, py, pz, None, valid),
                  lengths, periodic, level, self_mask=True)
    stencil_counts_launches += 1
    note_launch("stencil_counts", (px, py, pz, r2, valid, lengths, periodic, level), out)
    return out


def stencil_density(px, py, pz, h, valid, lengths, periodic, level, mass=None) -> torch.Tensor:
    """(n_cells, cap) float32 sums S_i = sum_{j != i} m_j W(r_ij / h_i) (B2);
    m_j = 1 when `mass` is None."""
    global stencil_density_launches
    planes = (px, py, pz, h) + (() if mass is None else (mass,))
    _check(planes, valid, lengths, periodic, level)
    if px.device.type == "cpu":
        return stencil_density_plain(px, py, pz, h, valid, lengths, periodic, level, mass)
    out = _launch(True, (px, py, pz, h, valid), (px, py, pz, mass, valid),
                  lengths, periodic, level, self_mask=True)
    stencil_density_launches += 1
    note_launch("stencil_density", (px, py, pz, h, valid, lengths, periodic, level, mass), out)
    return out


def stencil_cross(tgt, cand, lengths, periodic, level, op: str = "count",
                  mass_t=None, mass_c=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross pass between two DISJOINT particle sets A and B packed on one
    grid (B3, the contract of stencil_counts_pallas_cross).

    tgt = (x, y, z, w, valid) of set A, (n_cells, cap_a); cand the same for
    set B, (n_cells, cap_b); w is r2 for op="count" and h for
    op="density". Returns (A-side results on A's layout, B-side results on
    B's layout): each side counts (or sums m W over) the other set at its
    OWN radius, computed from its own end. mass_t / mass_c are per-slot
    masses of A / B (None: unit mass).
    """
    global stencil_cross_launches
    if op not in ("count", "density"):
        raise ValueError(f"op must be 'count' or 'density', got {op!r}")
    for planes, mass in ((tgt, mass_t), (cand, mass_c)):
        _check(tuple(planes[:4]) + (() if mass is None else (mass,)), planes[4],
               lengths, periodic, level)
    if tgt[0].device != cand[0].device:
        raise ValueError("target and candidate tables must be on one device")
    if tgt[0].device.type == "cpu":
        return stencil_cross_plain(tgt, cand, lengths, periodic, level, op, mass_t, mass_c)
    density = op == "density"
    ax, ay, az, aw, av = tgt
    bx, by, bz, bw, bv = cand
    res_a = _launch(density, (ax, ay, az, aw, av), (bx, by, bz, mass_c, bv),
                    lengths, periodic, level, self_mask=False)
    stencil_cross_launches += 1
    res_b = _launch(density, (bx, by, bz, bw, bv), (ax, ay, az, mass_t, av),
                    lengths, periodic, level, self_mask=False)
    stencil_cross_launches += 1
    note_launch("stencil_cross", (tgt, cand, lengths, periodic, level, op, mass_t, mass_c),
                (res_a, res_b))
    return res_a, res_b


def stencil_counts_asym(px, py, pz, r2, valid, lengths, periodic, level) -> torch.Tensor:
    """(n_cells, cap) int32 counts by the one-sided route (B4,
    impl="pallas_asym"): the kernel runs without the self mask, so every
    valid target with r2 > 0 counts itself (d2 = 0), and the wrapper
    subtracts that pair. Equals stencil_counts and impl="xla"."""
    global stencil_asym_launches
    _check((px, py, pz, r2), valid, lengths, periodic, level)
    if px.device.type == "cpu":
        return stencil_counts_asym_plain(px, py, pz, r2, valid, lengths, periodic, level)
    out = _launch(False, (px, py, pz, r2, valid), (px, py, pz, None, valid),
                  lengths, periodic, level, self_mask=False)
    stencil_asym_launches += 1
    out = out - (valid & (r2 > 0)).to(torch.int32)
    note_launch("stencil_counts_asym", (px, py, pz, r2, valid, lengths, periodic, level), out)
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


def cubic_spline_w(q: torch.Tensor) -> torch.Tensor:
    """Unnormalised cubic-spline SPH kernel (models/sph.py contract),
    written in the operation order of the CUDA kernel; q = inf gives 0."""
    w1 = 1.0 - 1.5 * q * q * (1.0 - 0.5 * q)
    t = 2.0 - q
    w2 = 0.25 * (t * t * t)
    return torch.where(q < 1.0, w1, torch.where(q < 2.0, w2, torch.zeros_like(q)))


def _stencil_plain(density: bool, tgt, cand, lengths, periodic, level,
                   self_mask: bool, max_pairs: int = 1 << 27) -> torch.Tensor:
    """Roll stencil from the target table's end: tgt = (x, y, z, r2 or h,
    valid), cand = (x, y, z, mass or None, valid); the two may have
    different caps. self_mask drops slot i of the centre cell (tgt and
    cand are then the same table).

    Valid slots are a prefix of each row, so both tables are first cut to
    their fullest row: the slots cut hold no pairs, and the dense
    (cells, cap_t, cap_c) pair tensors shrink to the occupied part. Those
    tensors are built for runs of cells holding about max_pairs pairs
    each, so large grids and caps fit in memory."""
    D = 1 << int(level)
    full_cap = tgt[0].shape[1]
    used_t = max(1, int(tgt[4].sum(dim=1).max()))
    used_c = max(1, int(cand[4].sum(dim=1).max()))
    tgt = tuple(a[:, :used_t] for a in tgt)
    cand = tuple(None if a is None else a[:, :used_c] for a in cand)
    cap_t, cap_c = used_t, used_c
    n_cells = D * D * D
    cshp = (D, D, D, cap_c)
    ex, ey, ez, ew, ev = tgt
    cx0, cy0, cz0, cv0 = (cand[i].reshape(cshp) for i in (0, 1, 2, 4))
    cm0 = None if cand[3] is None else cand[3].reshape(cshp)
    dev = ex.device
    lengths = lengths.to(device=dev, dtype=torch.float32)
    not_self = torch.arange(cap_t, device=dev)[:, None] != torch.arange(cap_c, device=dev)[None, :]
    inv_h = (1.0 / ew)[..., :, None] if density else None
    total = torch.zeros((n_cells, cap_t), dtype=torch.float32 if density else torch.int32, device=dev)
    run = max(1, max_pairs // (cap_t * cap_c))
    for dx, dy, dz in _directions():
        planes = _neighbour_planes(cx0, cy0, cz0, cv0, lengths, periodic, D, dx, dy, dz)
        cx, cy, cz, cv = (a.reshape(n_cells, cap_c) for a in planes)
        cm = None if cm0 is None else _roll3(cm0, dx, dy, dz).reshape(n_cells, cap_c)
        for s in range(0, n_cells, run):
            e = min(n_cells, s + run)
            d2 = _pair_d2(ex[s:e], ey[s:e], ez[s:e], cx[s:e], cy[s:e], cz[s:e])
            m = cv[s:e, None, :] & ev[s:e, :, None]
            if self_mask and dx == 0 and dy == 0 and dz == 0:
                m = m & not_self
            if density:
                w = cubic_spline_w(torch.sqrt(d2) * inv_h[s:e])
                if cm is not None:
                    w = w * cm[s:e, None, :]
                total[s:e] += torch.where(m, w, torch.zeros_like(w)).sum(dim=-1)
            else:
                total[s:e] += ((d2 < ew[s:e, :, None]) & m).sum(dim=-1, dtype=torch.int32)
    return torch.nn.functional.pad(total, (0, full_cap - cap_t))


def stencil_counts_plain(px, py, pz, r2, valid, lengths, periodic, level) -> torch.Tensor:
    """Plain version of stencil_counts (B1): (n_cells, cap) int32."""
    return _stencil_plain(False, (px, py, pz, r2, valid), (px, py, pz, None, valid),
                          lengths, periodic, level, self_mask=True)


def stencil_density_plain(px, py, pz, h, valid, lengths, periodic, level, mass=None) -> torch.Tensor:
    """Plain version of stencil_density (B2): (n_cells, cap) float32."""
    return _stencil_plain(True, (px, py, pz, h, valid), (px, py, pz, mass, valid),
                          lengths, periodic, level, self_mask=True)


def stencil_cross_plain(tgt, cand, lengths, periodic, level, op: str = "count",
                        mass_t=None, mass_c=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of stencil_cross (B3): the roll stencil with no self
    mask, once from each end."""
    density = op == "density"
    ax, ay, az, aw, av = tgt
    bx, by, bz, bw, bv = cand
    res_a = _stencil_plain(density, tgt, (bx, by, bz, mass_c, bv), lengths, periodic, level, False)
    res_b = _stencil_plain(density, cand, (ax, ay, az, mass_t, av), lengths, periodic, level, False)
    return res_a, res_b


def stencil_counts_asym_plain(px, py, pz, r2, valid, lengths, periodic, level) -> torch.Tensor:
    """Plain version of stencil_counts_asym (B4): the roll stencil with no
    self mask, minus the self pair."""
    counts = _stencil_plain(False, (px, py, pz, r2, valid), (px, py, pz, None, valid),
                            lengths, periodic, level, self_mask=False)
    return counts - (valid & (r2 > 0)).to(torch.int32)
