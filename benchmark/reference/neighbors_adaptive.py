"""Neighbour counts for radii that vary from particle to particle, in a
periodic cube: the semantics and the float32 arithmetic of neighbors.py
(j is a neighbour of i when j != i and d2 < (2 h_i)^2, the candidate's
coordinate moved by the cube's side where the pair crosses a periodic
face, d2 = (dx dx + dy dy) + dz dz), for samples whose radii differ 4x,
where a grid at the largest 2h would hold thousands of particles a cell.

The particles are binned in row-major order on a grid of about one
median radius a cell (`grid_level`). A target tests every particle
within `reach` cells of its own on each axis: floor(2h / side) cells and
one more for the rounding of where a distance starts and ends, and one
more for a position on the cube's upper face, whose cell is clamped to
the last. For one column offset (ox, oy) a target's candidates are at
most three runs of consecutive cells along z, so three slices of the
sorted particles: the run inside the cube and the parts wrapped across
its lower and upper face (moved by -side and +side). Pairs are tested in
flat blocks of about `block_pairs`.

With the particles' tiers it also counts, from the target's end, the
work the tiered pass needs: for each ordered pair of tiers (a, b) the
ordered pairs i in a, j in b with d2 < r2_i (A) and with d2 < r2_i and
d2 < r2_j (B). The unordered pairs with d < 2 max(h_i, h_j) are then
A - B / 2, summed over the tier pairs wanted (`unordered_pairs`)."""

from __future__ import annotations

import math

import torch

from .keys import cell_coords

MAX_LEVEL = 8
BLOCK_PAIRS = 1 << 25


def reach(h: torch.Tensor, length: float, level: int) -> torch.Tensor:
    """(n,) int64 cells a target searches on each side, at `level`; the
    1e-5 x length covers a float32 distance that passes the test a
    rounding beyond 2h."""
    side = length / (1 << level)
    return torch.floor((2.0 * h.double() + 1e-5 * length) / side).long() + 2


def grid_level(h: torch.Tensor, length: float) -> int:
    """About one median radius a cell, in [2, MAX_LEVEL], raised until no
    search spans the cube (2 reach + 1 cells at most a side)."""
    want = round(math.log2(length / float(h.float().median())))
    for level in range(max(2, min(MAX_LEVEL, want)), MAX_LEVEL + 1):
        if 2 * int(reach(h, length, level).max()) + 1 <= 1 << level:
            return level
    raise ValueError(f"radii up to {float(h.max()):.4g} span the periodic cube of side {length}")


def neighbor_counts_adaptive(x, y, z, h, lo: float, length: float, tier=None, n_tiers: int = 0,
                             block_pairs: int = BLOCK_PAIRS):
    """((n,) int64 neighbour counts, work): `work` is None without
    `tier`, else (A, B), two (n_tiers, n_tiers) int64 host tensors."""
    n, dev, f = x.numel(), x.device, x.dtype
    level = grid_level(h, length)
    d = 1 << level
    cx, cy, cz = cell_coords(x, y, z, lo, length, level)
    order = torch.argsort((cx * d + cy) * d + cz, stable=True)
    edge = torch.zeros(d ** 3 + 1, dtype=torch.int64, device=dev)
    edge[1:] = torch.cumsum(torch.bincount((cx * d + cy) * d + cz, minlength=d ** 3), 0)
    k = reach(h, length, level)
    kmax = int(k.max())
    widest = torch.argsort(k, descending=True, stable=True)
    at_least = torch.bincount(k, minlength=kmax + 1).flip(0).cumsum(0).flip(0).tolist()  # targets with reach >= m
    r2 = (2.0 * h) * (2.0 * h)
    side = torch.tensor(length, dtype=f, device=dev)
    counts = torch.zeros(n, dtype=torch.int64, device=dev)
    work = torch.zeros((2, max(1, n_tiers) ** 2), dtype=torch.int64, device=dev) if tier is not None else None
    z_shift = torch.tensor([0.0, -1.0, 1.0], dtype=f, device=dev)[:, None] * side
    for ox in range(-kmax, kmax + 1):
        for oy in range(-kmax, kmax + 1):
            t = widest[:at_least[max(abs(ox), abs(oy))]]
            if t.numel() == 0:
                continue
            kt, nx, ny = k[t], cx[t] + ox, cy[t] + oy
            base = ((nx % d) * d + ny % d) * d
            zlo, zhi = cz[t] - kt, cz[t] + kt
            # cells [first, last) of the run inside the cube, the part below its lower face, above its upper
            first = torch.stack([base + zlo.clamp(min=0), base + torch.where(zlo < 0, zlo + d, d), base])
            last = torch.stack([base + zhi.clamp(max=d - 1) + 1, base + d,
                                base + torch.where(zhi >= d, zhi - d + 1, 0)])
            start = edge[first].reshape(-1)
            runs = (edge[last].reshape(-1) - start)
            shifts = tuple(torch.div(a, d, rounding_mode="floor").to(f).mul(side).repeat(3) for a in (nx, ny))
            shifts += (z_shift.expand(3, t.numel()).reshape(-1),)
            _test_runs(t.repeat(3), start, runs, shifts, order, (x, y, z), r2, counts, tier, n_tiers, work,
                       block_pairs)
    if work is None:
        return counts, None
    a, b = work.view(2, n_tiers, n_tiers).cpu()
    return counts, (a, b)


def _test_runs(tgt, start, runs, shifts, order, xyz, r2, counts, tier, n_tiers, work, block_pairs):
    """Test target tgt[r] against the sorted particles start[r] ..
    start[r] + runs[r] - 1, each candidate moved by shifts[.][r], in
    blocks of whole runs."""
    dev = tgt.device
    cum = torch.cumsum(runs, 0)
    total = int(cum[-1])
    if total == 0:
        return
    marks = torch.arange(block_pairs, max(total, block_pairs), block_pairs, device=dev)
    bounds = [0] + torch.searchsorted(cum, marks, right=True).tolist() + [runs.numel()]
    excl = cum - runs
    edges = torch.cat([excl, cum[-1:]])[torch.tensor(bounds, device=dev)].tolist()
    for r0, r1, p0, p1 in zip(bounds[:-1], bounds[1:], edges[:-1], edges[1:]):
        if p1 == p0:
            continue
        rid = torch.repeat_interleave(torch.arange(r0, r1, device=dev), runs[r0:r1], output_size=p1 - p0)
        j = order[start[rid] + (torch.arange(p0, p1, device=dev) - excl[rid])]
        i = tgt[rid]
        dx = xyz[0][i] - (xyz[0][j] + shifts[0][rid])
        dy = xyz[1][i] - (xyz[1][j] + shifts[1][rid])
        dz = xyz[2][i] - (xyz[2][j] + shifts[2][rid])
        d2 = dx * dx + dy * dy + dz * dz
        ok = (d2 < r2[i]) & (i != j)
        counts.index_add_(0, i, ok.long())
        if work is not None:
            key = tier[i] * n_tiers + tier[j]
            work[0] += torch.bincount(key[ok], minlength=n_tiers ** 2)
            work[1] += torch.bincount(key[ok & (d2 < r2[j])], minlength=n_tiers ** 2)


def unordered_pairs(a: torch.Tensor, b: torch.Tensor, tiers=None) -> float:
    """The unordered pairs with d < 2 max(h_i, h_j) whose ends lie in the
    tiers (ta, tb) of `tiers` (every pair of tiers without it): the
    ordered pairs within the target's radius less half those within
    both radii, over both orders of each tier pair."""
    if tiers is None:
        return float(a.sum()) - float(b.sum()) / 2.0
    ta, tb = tiers
    cells = {(ta, tb), (tb, ta)}
    return sum(float(a[p]) - float(b[p]) / 2.0 for p in cells)
