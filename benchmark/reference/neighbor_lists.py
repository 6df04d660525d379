"""Fixed-radius neighbour lists in a box (cornerstone-octree
findneighbors.hpp: j is a neighbour of i when j != i and d2 < (2 h_i)^2),
every neighbour of every particle, by particle id.

Every pair is tested from its target's end in float32, each operation
rounded on its own: d = x_i - x_j per axis, on a periodic axis moved to
the minimum image d - L floor(d (1 / L) + 1/2) (the octree search's "v2"
image), d2 = (dx dx + dy dy) + dz dz, against r2 = (2 h_i)(2 h_i). The
particles are binned into the cells of a grid whose side is at least the
largest 2h, as neighbors.py bins them, so every neighbour lies in the 27
cells around a particle's own; pairs are tested a block of cells at a
time, and each target's hits are packed and sorted by id."""

from __future__ import annotations

import itertools
import math

import torch

from .keys import cell_coords


def neighbor_lists(x, y, z, h, lo: float, length: float, periodic: bool = True,
                   block_pairs: int = 1 << 25):
    """(counts (n,) int64, lists (n, K) int64): each particle's neighbours
    by id, ascending, padded with -1 to K, the largest count."""
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
    tgt = [c[idx] for c in (x, y, z)]
    r2 = (2.0 * h[idx]) * (2.0 * h[idx])

    f32 = torch.float32
    side = torch.tensor(length, dtype=f32, device=dev)
    pl = side if periodic else torch.zeros((), dtype=f32, device=dev)
    il = torch.ones((), dtype=f32, device=dev) / side
    g = torch.arange(d, device=dev)
    gx, gy, gz = (a.reshape(-1) for a in torch.meshgrid(g, g, g, indexing="ij"))
    near = torch.stack([((gx + ox) % d * d + (gy + oy) % d) * d + (gz + oz) % d
                        for ox, oy, oz in itertools.product((-1, 0, 1), repeat=3)], dim=1)  # (d^3, 27)

    counts = torch.zeros(n, dtype=torch.int64, device=dev)
    blocks = []  # (ids of the block's targets, their sorted hits padded with n)
    block = max(1, block_pairs // max(1, 27 * width * width))
    for s in range(0, d ** 3, block):
        e = min(d ** 3, s + block)
        cand = table[near[s:e]].reshape(e - s, -1)  # (B, 27 width), -1 for empty slots
        c = cand.clamp(min=0)
        d2 = None
        for a, coord in enumerate((x, y, z)):
            da = tgt[a][s:e, :, None] - coord[c][:, None, :]
            da = da - pl * torch.floor(da * il + 0.5)
            d2 = da * da if d2 is None else d2 + da * da
        hit = (d2 < r2[s:e, :, None]) & (cand >= 0)[:, None, :] & valid[s:e, :, None] \
            & (cand[:, None, :] != table[s:e, :, None])
        cnt = hit.sum(dim=-1)
        kb = int(cnt.max()) if cnt.numel() else 0
        slot = torch.where(hit, torch.cumsum(hit, dim=-1) - 1, kb)  # column kb takes the misses
        packed = torch.full((e - s, width, kb + 1), n, dtype=torch.int64, device=dev)
        packed.scatter_(2, slot, cand[:, None, :].expand_as(slot))
        ok = valid[s:e]
        counts[table[s:e][ok]] = cnt[ok]
        blocks.append((table[s:e][ok], packed[..., :kb][ok].sort(dim=-1).values))
    k = max((b[1].shape[1] for b in blocks), default=0)
    lists = torch.full((n, k), -1, dtype=torch.int64, device=dev)
    for ids, rows in blocks:
        lists[ids, :rows.shape[1]] = torch.where(rows < n, rows, -1)
    return counts, lists
