"""Fixed-radius neighbour counts in a periodic cube (cornerstone-octree
findneighbors.hpp: j is a neighbour of i when j != i and d2 < (2 h_i)^2).

Every pair is tested from its target's end, in float32 with each
operation rounded on its own: the candidate's coordinate moved by the
cube's side where the pair crosses a periodic face, d = x_i - x_j per
axis, d2 = (dx dx + dy dy) + dz dz, against r2 = (2 h_i)(2 h_i). The
particles are binned into the cells of a grid whose side is at least the
largest 2h, so every neighbour lies in the 27 cells around a particle's
own; the bins are padded to the fullest one and pairs are tested a block
of cells at a time."""

from __future__ import annotations

import itertools
import math

import torch

from .keys import cell_coords


def neighbor_counts(x, y, z, h, lo: float, length: float, block_pairs: int = 1 << 25) -> torch.Tensor:
    """(n,) int64 neighbour counts of every particle, on a grid of 2^level
    cells a side, the finest (up to 2^8) whose cell is at least 2 max(h)
    wide; at least 4 cells a side, so that the 27 cells around one are
    distinct."""
    n, dev = x.numel(), x.device
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
    r2 = (2.0 * h[idx]) * (2.0 * h[idx])

    g = torch.arange(d, device=dev)
    gx, gy, gz = (a.reshape(-1) for a in torch.meshgrid(g, g, g, indexing="ij"))
    side = torch.tensor(length, dtype=x.dtype, device=dev)
    counts = torch.zeros((d ** 3, width), dtype=torch.int64, device=dev)
    block = max(1, block_pairs // max(1, width * width))
    for ox, oy, oz in itertools.product((-1, 0, 1), repeat=3):
        nb = [(a + o) for a, o in ((gx, ox), (gy, oy), (gz, oz))]
        shift = [torch.div(a, d, rounding_mode="floor").to(x.dtype) * side for a in nb]
        ncell = ((nb[0] % d) * d + nb[1] % d) * d + nb[2] % d
        for s in range(0, d ** 3, block):
            e = min(d ** 3, s + block)
            cand = table[ncell[s:e]]
            cok = cand >= 0
            c = cand.clamp(min=0)
            ddx = tx[s:e, :, None] - (x[c] + shift[0][s:e, None])[:, None, :]
            ddy = ty[s:e, :, None] - (y[c] + shift[1][s:e, None])[:, None, :]
            ddz = tz[s:e, :, None] - (z[c] + shift[2][s:e, None])[:, None, :]
            d2 = ddx * ddx + ddy * ddy + ddz * ddz
            ok = (d2 < r2[s:e, :, None]) & cok[:, None, :] & valid[s:e, :, None]
            if ox == oy == oz == 0:
                ok &= cand[:, None, :] != table[s:e, :, None]
            counts[s:e] += ok.sum(dim=-1)
    out = torch.zeros(n, dtype=torch.int64, device=dev)
    out[table[valid]] = counts[valid]
    return out
