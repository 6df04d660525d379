"""The SPH density of every particle (cornerstone-octree
find_neighbors.cuh:94-124, SPH-EXA's density loop): for each particle i,

    rho_i = (1 / (pi h_i^3)) * (sum over j != i with |r_ij| < 2 h_i of
            m_j W(|r_ij| / h_i), plus m_i W(0))

with W the cubic spline, unnormalised (W(0) = 1, zero from q = 2 on).

Computed in float32 with each operation rounded on its own, in the order
the program's kernel contract states (ops/stencil.py): the candidate's
coordinate moved by the cube's side where the pair crosses a periodic
face, d = x_i - x_j per axis, d2 = (dx dx + dy dy) + dz dz, q =
sqrt(d2) * (1 / h_i), the spline as below, times m_j; the sum, plus
m_i, then times 1/h_i three times and by 1/pi rounded to float32. The
binning is that of neighbors.py: a grid whose cell is at least 2 max(h)
wide, each particle tested against the 27 cells around its own, a block
of cells at a time.

Departures from the published description: the kernel is the
unnormalised spline W(q) = 1 - 1.5 q^2 (1 - 0.5 q) for q < 1 and
0.25 (2 - q)^3 for 1 <= q < 2, the normalisation 1/pi applied once to
the sum (the 3D cubic spline's 1/(pi h^3)); float32 throughout, not the
reference's templated type (SPH-EXA runs float or double); a pair is
tested from its target's end only, as the program's contract has it,
so the two ends of a pair across a periodic face may see d2 rounded
apart. Open boxes (`periodic=False`) drop the cells past the faces."""

from __future__ import annotations

import itertools
import math

import torch

from .keys import cell_coords

# no matrix product runs here; any later one stays in float32 on the card
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

INV_PI = float(torch.tensor(1.0 / math.pi, dtype=torch.float32))  # 1/pi rounded to float32


def cubic_spline(q: torch.Tensor) -> torch.Tensor:
    """The unnormalised cubic spline, each operation rounded on its own:
    1 - 1.5 q q (1 - 0.5 q) below 1, 0.25 (2 - q)^3 below 2, else 0."""
    w1 = 1.0 - 1.5 * q * q * (1.0 - 0.5 * q)
    t = 2.0 - q
    w2 = 0.25 * (t * t * t)
    return torch.where(q < 1.0, w1, torch.where(q < 2.0, w2, torch.zeros_like(q)))


def sph_density(x, y, z, h, m, lo: float, length: float, periodic: bool = True,
                block_pairs: int = 1 << 24):
    """(rho, near, inner) of every particle, in the inputs' dtype (float32
    for the reference; the control passes bfloat16): rho the density,
    near (int64) the neighbours j != i with q < 2 (the terms of the sum),
    inner (int64) those with q < 1. The grid is the finest (up to 2^8
    cells a side) whose cell is at least 2 max(h) wide, at least 4 cells
    a side, so that the 27 cells around one are distinct."""
    n, dev, dt = x.numel(), x.device, x.dtype
    level = min(8, int(math.floor(math.log2(length / float(2.0 * h.max())))))
    if level < 2:
        raise ValueError(f"the search radius 2h = {float(2 * h.max())} leaves fewer than 4 cells a side")
    d = 1 << level
    cx, cy, cz = cell_coords(x, y, z, lo, length, level)
    cell = (cx * d + cy) * d + cz
    order = torch.argsort(cell, stable=True)
    occ = torch.bincount(cell, minlength=d ** 3)
    first = torch.cumsum(occ, 0) - occ
    width = int(occ.max())
    table = torch.full((d ** 3, width), -1, dtype=torch.int64, device=dev)
    sc = cell[order]
    table[sc, torch.arange(n, device=dev) - first[sc]] = order
    valid = table >= 0
    idx = table.clamp(min=0)
    tx, ty, tz = x[idx], y[idx], z[idx]
    inv_h = 1.0 / h[idx]

    g = torch.arange(d, device=dev)
    gx, gy, gz = (a.reshape(-1) for a in torch.meshgrid(g, g, g, indexing="ij"))
    side = torch.tensor(length, dtype=dt, device=dev)
    wsum = torch.zeros((d ** 3, width), dtype=dt, device=dev)
    near = torch.zeros((d ** 3, width), dtype=torch.int64, device=dev)
    inner = torch.zeros((d ** 3, width), dtype=torch.int64, device=dev)
    block = max(1, block_pairs // max(1, width * width))
    for ox, oy, oz in itertools.product((-1, 0, 1), repeat=3):
        nb = [(a + o) for a, o in ((gx, ox), (gy, oy), (gz, oz))]
        over = [torch.div(a, d, rounding_mode="floor") for a in nb]
        shift = [o.to(dt) * side for o in over]
        inside = (over[0] == 0) & (over[1] == 0) & (over[2] == 0)
        ncell = ((nb[0] % d) * d + nb[1] % d) * d + nb[2] % d
        for s in range(0, d ** 3, block):
            e = min(d ** 3, s + block)
            cand = table[ncell[s:e]]
            cok = (cand >= 0) if periodic else (cand >= 0) & inside[s:e, None]
            c = cand.clamp(min=0)
            cxs = x[c] + shift[0][s:e, None] if periodic else x[c]
            cys = y[c] + shift[1][s:e, None] if periodic else y[c]
            czs = z[c] + shift[2][s:e, None] if periodic else z[c]
            ddx = tx[s:e, :, None] - cxs[:, None, :]
            ddy = ty[s:e, :, None] - cys[:, None, :]
            ddz = tz[s:e, :, None] - czs[:, None, :]
            d2 = ddx * ddx + ddy * ddy + ddz * ddz
            q = torch.sqrt(d2) * inv_h[s:e, :, None]
            ok = cok[:, None, :] & valid[s:e, :, None]
            if ox == oy == oz == 0:
                ok &= cand[:, None, :] != table[s:e, :, None]
            term = cubic_spline(q) * m[c][:, None, :]
            wsum[s:e] += torch.where(ok, term, torch.zeros_like(term)).sum(dim=-1)
            near[s:e] += (ok & (q < 2.0)).sum(dim=-1)
            inner[s:e] += (ok & (q < 1.0)).sum(dim=-1)
    tm = m[idx]
    rho_cell = torch.tensor(INV_PI, dtype=dt, device=dev) * ((wsum + tm) * inv_h * inv_h * inv_h)
    rho = torch.zeros(n, dtype=dt, device=dev)
    k_near = torch.zeros(n, dtype=torch.int64, device=dev)
    k_inner = torch.zeros(n, dtype=torch.int64, device=dev)
    rho[table[valid]] = rho_cell[valid]
    k_near[table[valid]] = near[valid]
    k_inner[table[valid]] = inner[valid]
    return rho, k_near, k_inner
