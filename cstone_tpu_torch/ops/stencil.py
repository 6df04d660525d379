"""27-point cell-list stencil: the hand-written CUDA kernels, their plain
PyTorch versions, and the wrappers that choose between them.

Replaces the Pallas TPU kernels of `cstone_tpu/ops/pallas_stencil.py`:

  B1  `_kernel_sym` op="count" (:295)     -> stencil_counts      (csrc/stencil_sym.cu)
  B2  `_kernel_sym` op="density" (:295)   -> stencil_density     (csrc/stencil_sym.cu)
  B3  `_kernel_sym` cross=True (:589)     -> stencil_cross       (csrc/stencil_sym.cu)
  B4  `_kernel` (:149), impl="pallas_asym" -> stencil_counts_asym (csrc/stencil_sym.cu)

Contract (celllist.stencil_neighbor_counts, reference
findneighbors.hpp:96-165): inputs are (n_cells, cap) ELL planes in
row-major cell order of a D^3 grid, D = 2^level; valid slots form a prefix
of each row (ell_pack and ell_pack_gather build them so). Target slot i
counts candidates j of the 27 neighbour cells with d2 < r2_i (count), or
sums m_j W(sqrt(d2) / h_i) (density). Periodic dims wrap and shift the
candidate coordinate by +-L; open dims drop the ghost cells. B1/B2 exclude
self by slot identity in the centre cell only, so coincident distinct
particles count each other; B3 runs between two disjoint sets (target and
candidate tables with their own caps) with no self mask and returns both
sides; B4 counts the self pair and subtracts it afterwards, the JAX
one-sided kernel's contract. Invalid slots give 0.

All versions compute d2 as ((dx*dx + dy*dy) + dz*dz) in float32 with
every operation rounded on its own (the kernels are compiled with
--fmad=false), from the end that tests it, so counts agree bit for bit;
density sums differ only in summation order.

Kernel design, csrc/stencil_sym.cu (B1-B4): one warp per (cell, 32 lane
slots) that holds valid slots, taken from a work list the kernel builds
on the card; staged chunks packed as float4 with double-buffered
cp.async and only warp barriers. B1/B2 walk a half stencil of one table
(centre cell j > i and the 13 forward cells) and B3 the 27 cells of the
other table (its lanes on the table whose busy chunks are fuller,
cross_lanes_on_b, decided on the card, one launch for both sides): each
pair is tested once and credited to both ends (staged ends by warp
ballot or shuffle sum, then global atomics into zeroed outputs). B4 (the
one-sided mode) walks all 27 cells from the lane end only, in units of
64 slots (two a lane where a row holds more than 32): each lane owns its
counts, no atomics. Counts are deterministic; density sums are
float atomics, so their last bits vary from run to run.
stencil_sym_plain and stencil_cross_sym_plain mirror the symmetric
decompositions in PyTorch for the tests.

CPU tensors take the plain version; CUDA tensors always launch a kernel,
and a build or launch failure raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .cuda_lib import CudaLibrary, LaunchCounts, check_launch, ptr, register_launches, stream_of

__all__ = [
    "stencil_counts",
    "stencil_density",
    "stencil_cross",
    "stencil_counts_asym",
    "stencil_counts_plain",
    "stencil_density_plain",
    "stencil_cross_plain",
    "stencil_counts_asym_plain",
    "stencil_sym_plain",
    "stencil_cross_sym_plain",
    "cross_lanes_on_b",
    "load_library",
    "launches",
    "reset_launches",
]


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.cstone_stencil_sym.argtypes = [i, p, p, p, p, p, p, i, p, i, i, i, i, p, p, p, p, p]
    lib.cstone_stencil_sym.restype = i
    lib.cstone_stencil_cross.argtypes = [i, p, p, p, p, p, p, i, p, p, p, p, p, p, i,
                                         p, i, i, i, i, p, p, p, p, p, p, p, p]
    lib.cstone_stencil_cross.restype = i
    lib.cstone_stencil_one_sided.argtypes = [p, p, p, p, p, i, p, i, i, i, i, p, p, p, p, p]
    lib.cstone_stencil_one_sided.restype = i


LIBRARY = CudaLibrary("stencil_sym.cu", _bind)

# one count per wrapper, incremented where the kernel launches
_LAUNCHES = LaunchCounts("stencil_counts", "stencil_density", "stencil_cross", "stencil_counts_asym")


def load_library() -> ctypes.CDLL:
    """Build csrc/stencil_sym.cu (once per source version) and load it."""
    return LIBRARY.load()


def launches() -> dict:
    return _LAUNCHES.snapshot()


def reset_launches() -> None:
    _LAUNCHES.reset()


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


def _scratch(n_tables: int, n_cells: int, cap: int, dev):
    """The symmetric kernel's scratch in one int32 buffer: 5 unsigned 64-bit
    counters (the kernel zeroes them), the row lengths (n_tables, n_cells)
    and the work lists (n_tables, n_cells * ceil(cap / 32))."""
    n_list = n_cells * -(-cap // 32)
    buf = torch.empty(10 + n_tables * (n_cells + n_list), dtype=torch.int32, device=dev)
    rows = buf[10:10 + n_tables * n_cells].view(n_tables, n_cells)
    return rows, buf[10 + n_tables * n_cells:].view(n_tables, n_list), buf[:10]


def _launch_sym(density: bool, px, py, pz, w, mass, valid, lengths, periodic,
                level) -> torch.Tensor:
    """One launch of the half-stencil kernel (B1 with w = r2, B2 with
    w = h and mass or None) into a zeroed output."""
    dev = px.device
    lib = LIBRARY.load()
    lengths = lengths.to(device=dev, dtype=torch.float32).contiguous()
    out = torch.zeros(px.shape, dtype=torch.float32 if density else torch.int32, device=dev)
    row_counts, units, stats = _scratch(1, px.shape[0], px.shape[1], dev)
    err = lib.cstone_stencil_sym(
        int(density), ptr(px), ptr(py), ptr(pz), ptr(w), ptr(mass), ptr(valid), px.shape[1],
        ptr(lengths), int(periodic[0]), int(periodic[1]), int(periodic[2]), int(level),
        ptr(row_counts), ptr(units), ptr(stats), ptr(out), stream_of(px))
    check_launch(err, "stencil_sym")
    return out


def _launch_one_sided(px, py, pz, r2, valid, lengths, periodic, level) -> torch.Tensor:
    """One launch of the one-sided mode of csrc/stencil_sym.cu (B4) into a
    zeroed output: counts with the self pair included."""
    dev = px.device
    lib = LIBRARY.load()
    lengths = lengths.to(device=dev, dtype=torch.float32).contiguous()
    out = torch.zeros(px.shape, dtype=torch.int32, device=dev)
    row_counts, units, stats = _scratch(1, px.shape[0], px.shape[1], dev)
    err = lib.cstone_stencil_one_sided(
        ptr(px), ptr(py), ptr(pz), ptr(r2), ptr(valid), px.shape[1], ptr(lengths),
        int(periodic[0]), int(periodic[1]), int(periodic[2]), int(level),
        ptr(row_counts), ptr(units), ptr(stats), ptr(out), stream_of(px))
    check_launch(err, "stencil_one_sided")
    return out


def _launch_cross(density: bool, ta, tb, lengths, periodic, level):
    """One launch of the cross kernel (B3) between two disjoint tables, each
    (x, y, z, r2 or h, mass or None, valid), into zeroed outputs: (results
    on ta's layout, results on tb's layout). The kernel puts its lanes on
    the table whose busy 32-slot chunks are fuller (cross_lanes_on_b)."""
    dev = ta[0].device
    lib = LIBRARY.load()
    lengths = lengths.to(device=dev, dtype=torch.float32).contiguous()
    dtype = torch.float32 if density else torch.int32
    outs = tuple(torch.zeros(t[0].shape, dtype=dtype, device=dev) for t in (ta, tb))
    row_counts, units, stats = _scratch(2, ta[0].shape[0], max(ta[0].shape[1], tb[0].shape[1]), dev)
    err = lib.cstone_stencil_cross(
        int(density), *(ptr(a) for a in ta), ta[0].shape[1],
        *(ptr(a) for a in tb), tb[0].shape[1], ptr(lengths),
        int(periodic[0]), int(periodic[1]), int(periodic[2]), int(level),
        ptr(row_counts[0]), ptr(row_counts[1]), ptr(units[0]), ptr(units[1]), ptr(stats),
        ptr(outs[0]), ptr(outs[1]), stream_of(ta[0]))
    check_launch(err, "stencil_cross")
    return outs


def cross_lanes_on_b(valid_a: torch.Tensor, valid_b: torch.Tensor) -> bool:
    """Which table the cross kernel (B3) puts its lanes on, as it decides it
    on the card: B when B's busy 32-slot chunks hold more valid slots each
    than A's (ties and empty tables: A). The decision changes no count."""
    def chunks_and_slots(valid):
        n = valid.sum(dim=1)
        return int(((n + 31) // 32).sum()), int(n.sum())

    (ca, sa), (cb, sb) = chunks_and_slots(valid_a), chunks_and_slots(valid_b)
    return sb * ca > sa * cb


# ----------------------------------------------------------------------------
# public wrappers
# ----------------------------------------------------------------------------

def stencil_counts(px, py, pz, r2, valid, lengths, periodic, level) -> torch.Tensor:
    """(n_cells, cap) int32 neighbor counts #{j != i : d2 < r2_i} (B1)."""
    _check((px, py, pz, r2), valid, lengths, periodic, level)
    if px.device.type == "cpu":
        return stencil_counts_plain(px, py, pz, r2, valid, lengths, periodic, level)
    out = _launch_sym(False, px, py, pz, r2, None, valid, lengths, periodic, level)
    _LAUNCHES.launched("stencil_counts", (px, py, pz, r2, valid, lengths, periodic, level), out)
    return out


def stencil_density(px, py, pz, h, valid, lengths, periodic, level, mass=None) -> torch.Tensor:
    """(n_cells, cap) float32 sums S_i = sum_{j != i} m_j W(r_ij / h_i) (B2);
    m_j = 1 when `mass` is None. On the card the terms are summed with
    float atomics, so the last bits of a sum vary from run to run (within
    rtol 1e-5 of stencil_density_plain)."""
    planes = (px, py, pz, h) + (() if mass is None else (mass,))
    _check(planes, valid, lengths, periodic, level)
    if px.device.type == "cpu":
        return stencil_density_plain(px, py, pz, h, valid, lengths, periodic, level, mass)
    out = _launch_sym(True, px, py, pz, h, mass, valid, lengths, periodic, level)
    _LAUNCHES.launched("stencil_density", (px, py, pz, h, valid, lengths, periodic, level, mass), out)
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
    masses of A / B (None: unit mass). On the card one launch tests each
    A-B pair once and credits both ends; density sums are then float
    atomics, so their last bits vary from run to run (within rtol 1e-5 of
    stencil_cross_plain). Counts are bit-equal to it.
    """
    if op not in ("count", "density"):
        raise ValueError(f"op must be 'count' or 'density', got {op!r}")
    for planes, mass in ((tgt, mass_t), (cand, mass_c)):
        _check(tuple(planes[:4]) + (() if mass is None else (mass,)), planes[4],
               lengths, periodic, level)
    if tgt[0].device != cand[0].device:
        raise ValueError("target and candidate tables must be on one device")
    if tgt[0].device.type == "cpu":
        return stencil_cross_plain(tgt, cand, lengths, periodic, level, op, mass_t, mass_c)
    ax, ay, az, aw, av = tgt
    bx, by, bz, bw, bv = cand
    res_a, res_b = _launch_cross(op == "density", (ax, ay, az, aw, mass_t, av),
                                 (bx, by, bz, bw, mass_c, bv), lengths, periodic, level)
    _LAUNCHES.launched("stencil_cross", (tgt, cand, lengths, periodic, level, op, mass_t, mass_c),
                (res_a, res_b))
    return res_a, res_b


def stencil_counts_asym(px, py, pz, r2, valid, lengths, periodic, level) -> torch.Tensor:
    """(n_cells, cap) int32 counts by the one-sided route (B4,
    impl="pallas_asym"): the kernel runs without the self mask, so every
    valid target with r2 > 0 counts itself (d2 = 0), and the wrapper
    subtracts that pair. Equals stencil_counts and impl="xla"."""
    _check((px, py, pz, r2), valid, lengths, periodic, level)
    if px.device.type == "cpu":
        return stencil_counts_asym_plain(px, py, pz, r2, valid, lengths, periodic, level)
    out = _launch_one_sided(px, py, pz, r2, valid, lengths, periodic, level)
    out = out - (valid & (r2 > 0)).to(torch.int32)
    _LAUNCHES.launched("stencil_counts_asym", (px, py, pz, r2, valid, lengths, periodic, level), out)
    return out


# ----------------------------------------------------------------------------
# plain versions: the 27-point roll stencil (celllist.py:356-414)
# ----------------------------------------------------------------------------

def _roll3(a: torch.Tensor, dx: int, dy: int, dz: int) -> torch.Tensor:
    """a is (D, D, D, ...); rolled so cell (i,j,k) sees (i+dx, j+dy, k+dz)."""
    return torch.roll(a, shifts=(-dx, -dy, -dz), dims=(0, 1, 2))


def _wrap_over(D: int, d: int, axis: int, dev) -> torch.Tensor:
    """-1, 0 or +1 per target cell along `axis`: how direction d crosses
    the grid's edge, shaped to broadcast over (D, D, D, cap)."""
    over = torch.div(torch.arange(D, device=dev) + d, D, rounding_mode="floor")
    shape = [1, 1, 1, 1]
    shape[axis] = D
    return over.reshape(shape)


def _neighbour_planes(ex, ey, ez, ev, lengths, periodic, D, dx, dy, dz):
    """Candidate planes of direction (dx, dy, dz): rolled coordinates with
    the +-L wrap shift on periodic dims, validity masked on open dims."""
    cx, cy, cz, cv = (_roll3(a, dx, dy, dz) for a in (ex, ey, ez, ev))
    coords = [cx, cy, cz]
    for axis, d in enumerate((dx, dy, dz)):
        if d == 0:
            continue
        over = _wrap_over(D, d, axis, ex.device)
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


def _end_terms(density: bool, d2, own_key, other_m):
    """One end's terms of its pair tests: d2 < r2 (counts, own_key = r2), or
    W(sqrt(d2) / h) times the other end's mass (density, own_key = 1/h)."""
    if not density:
        return (d2 < own_key).to(torch.int32)
    t = cubic_spline_w(torch.sqrt(d2) * own_key)
    return t if other_m is None else t * other_m


def _both_ends(density: bool, ok, at_i, at_j):
    """(sums over j of the i-end terms, sums over i of the j-end terms) of
    (..., n_i, n_j) pair tensors, over the pairs in `ok`."""
    dtype = torch.float32 if density else torch.int32
    zero = torch.zeros((), dtype=at_i.dtype, device=at_i.device)
    return (torch.where(ok, at_i, zero).sum(dim=-1, dtype=dtype),
            torch.where(ok, at_j, zero).sum(dim=-2, dtype=dtype))


def _seen_from_neighbour(x, y, z, lengths, periodic, D, dx, dy, dz):
    """Coordinates of each cell's slots as the cell at direction (dx, dy, dz)
    sees them: shifted by -o L on the periodic axes that direction wraps."""
    seen = [x, y, z]
    for axis, d in enumerate((dx, dy, dz)):
        if d != 0 and periodic[axis]:
            over = _wrap_over(D, d, axis, x.device)
            seen[axis] = seen[axis] + (-over).to(torch.float32) * lengths[axis]
    return seen


def stencil_sym_plain(density: bool, px, py, pz, w, valid, lengths, periodic, level,
                      mass=None) -> torch.Tensor:
    """Plain mirror of the half-stencil kernel's decomposition
    (csrc/stencil_sym.cu): B1 with density=False and w = r2, B2 with
    density=True, w = h and `mass` (None: unit mass). (n_cells, cap) int32
    counts or float32 sums, equal to stencil_counts_plain bit for bit and to
    stencil_density_plain up to summation order.

    The centre cell's slot pairs j > i and the 13 forward directions each
    give every unordered pair once; each end is credited with its own test
    (its own r2, or its own 1/h and the other end's mass), and the
    candidate-end sums are rolled back onto the candidate's cell. On a
    direction that crosses a periodic edge the candidate end takes d2 from
    its own end, x_j - (x_i - o L); elsewhere that equals the target end's
    d2 bit for bit. Dense (cells, cap, cap) pair tensors: small grids only.
    """
    D = 1 << int(level)
    full_cap = px.shape[1]
    cap = max(1, int(valid.sum(dim=1).max()))
    shp = (D, D, D, cap)
    x, y, z, w, v = (a[:, :cap].reshape(shp) for a in (px, py, pz, w, valid))
    m = None if mass is None else mass[:, :cap].reshape(shp)
    dev = px.device
    lengths = lengths.to(device=dev, dtype=torch.float32)
    key = 1.0 / w if density else w  # the per-end value each test reads: 1/h or r2

    total = torch.zeros(shp, dtype=torch.float32 if density else torch.int32, device=dev)
    # centre cell: slot pairs j > i, one d2 serves both ends
    d2 = _pair_d2(x, y, z, x, y, z)
    ok = v[..., :, None] & v[..., None, :] & torch.ones(cap, cap, dtype=torch.bool, device=dev).triu(1)
    mi = None if m is None else m[..., :, None]
    mj = None if m is None else m[..., None, :]
    at_i, at_j = _both_ends(density, ok, _end_terms(density, d2, key[..., :, None], mj),
                            _end_terms(density, d2, key[..., None, :], mi))
    total += at_i + at_j
    for dx, dy, dz in _directions()[14:]:  # the 13 forward directions
        cx, cy, cz, cv = _neighbour_planes(x, y, z, v, lengths, periodic, D, dx, dy, dz)
        rx, ry, rz, rkey = (_roll3(a, dx, dy, dz) for a in (x, y, z, key))
        rm = None if m is None else _roll3(m, dx, dy, dz)
        seen = _seen_from_neighbour(x, y, z, lengths, periodic, D, dx, dy, dz)
        d2i = _pair_d2(x, y, z, cx, cy, cz)
        d2j = _pair_d2(rx, ry, rz, *seen).transpose(-1, -2)
        ok = v[..., :, None] & cv[..., None, :]
        at_i, at_j = _both_ends(
            density, ok,
            _end_terms(density, d2i, key[..., :, None], None if rm is None else rm[..., None, :]),
            _end_terms(density, d2j, rkey[..., None, :], mi))
        total += at_i + torch.roll(at_j, shifts=(dx, dy, dz), dims=(0, 1, 2))
    return torch.nn.functional.pad(total.reshape(D ** 3, cap), (0, full_cap - cap))


def stencil_cross_sym_plain(tgt, cand, lengths, periodic, level, op: str = "count",
                            mass_t=None, mass_c=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain mirror of the cross kernel's decomposition (B3 in
    csrc/stencil_sym.cu), with the arguments and results of stencil_cross:
    the lanes go on the table cross_lanes_on_b picks, each cell of that
    table meets all 27 neighbour cells of the other (the staged table),
    each A-B pair is tested once, and both ends are credited, each at its
    own radius from its own end (the staged end rolled back onto its cell).
    Across a periodic edge the staged end takes d2 as x_s - (x_l - o L);
    elsewhere that equals the lane end's d2 bit for bit. Counts equal
    stencil_cross_plain bit for bit, density sums up to summation order.
    Dense (cells, cap_lane, cap_staged) pair tensors: small grids only."""
    density = op == "density"
    D = 1 << int(level)
    dev = tgt[0].device
    lengths = lengths.to(device=dev, dtype=torch.float32)

    def cut(table, mass):  # to the fullest row, as (D, D, D, cap) planes
        cap = max(1, int(table[4].sum(dim=1).max()))
        shp = (D, D, D, cap)
        x, y, z, w, v = (a[:, :cap].reshape(shp) for a in table)
        m = None if mass is None else mass[:, :cap].reshape(shp)
        return x, y, z, 1.0 / w if density else w, v, m

    lanes_b = cross_lanes_on_b(tgt[4], cand[4])
    a, b = (tgt, mass_t), (cand, mass_c)
    (lanes, l_mass), (staged, s_mass) = (b, a) if lanes_b else (a, b)
    lx, ly, lz, lkey, lv, lm = cut(lanes, l_mass)
    sx, sy, sz, skey, sv, sm = cut(staged, s_mass)
    dtype = torch.float32 if density else torch.int32
    total_l = torch.zeros(lx.shape, dtype=dtype, device=dev)
    total_s = torch.zeros(sx.shape, dtype=dtype, device=dev)
    for dx, dy, dz in _directions():
        cx, cy, cz, cv = _neighbour_planes(sx, sy, sz, sv, lengths, periodic, D, dx, dy, dz)
        rx, ry, rz, rkey = (_roll3(a, dx, dy, dz) for a in (sx, sy, sz, skey))
        rm = None if sm is None else _roll3(sm, dx, dy, dz)
        seen = _seen_from_neighbour(lx, ly, lz, lengths, periodic, D, dx, dy, dz)
        d2l = _pair_d2(lx, ly, lz, cx, cy, cz)
        d2s = _pair_d2(rx, ry, rz, *seen).transpose(-1, -2)
        ok = lv[..., :, None] & cv[..., None, :]
        at_l, at_s = _both_ends(
            density, ok,
            _end_terms(density, d2l, lkey[..., :, None], None if rm is None else rm[..., None, :]),
            _end_terms(density, d2s, rkey[..., None, :], None if lm is None else lm[..., :, None]))
        total_l += at_l
        total_s += torch.roll(at_s, shifts=(dx, dy, dz), dims=(0, 1, 2))

    def uncut(total, table):
        return torch.nn.functional.pad(total.reshape(D ** 3, -1),
                                       (0, table[0].shape[1] - total.shape[-1]))

    res_l, res_s = uncut(total_l, lanes), uncut(total_s, staged)
    return (res_s, res_l) if lanes_b else (res_l, res_s)


register_launches(_LAUNCHES, plain={
    "stencil_counts": stencil_counts_plain,
    "stencil_density": stencil_density_plain,
    "stencil_cross": stencil_cross_plain,
    "stencil_counts_asym": stencil_counts_asym_plain,
})
