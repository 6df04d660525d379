"""Barnes-Hut monopole gravity on the linked octree (counterpart of
cstone_tpu/models/nbody.py; the syncGrav client: cornerstone provides the
tree and the MAC machinery, reference include/cstone/traversal/macs.hpp,
focus/source_center.hpp).

Targets are SFC-compact particle groups. Per group, nodes that pass the
vector MAC against the group's bounding box, while their parent fails it,
contribute their monopole (mass at the centre of mass) to every particle
of the group; leaves that fail it are collected for direct
particle-particle sums.

The JAX package walks the monopoles depth first per group from a
128-entry stack; the port walks breadth first over one flat list of
(group, node) pairs, which drops no visit, and collects the P2P leaves by
traversal.batched_collect_leaves (breadth first as well). The sums run in
another order than JAX's, so the accelerations agree to a relative
tolerance, not bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..sfc.box import Box
from ..traversal.boxoverlap import min_distance_point_box
from ..traversal.traversal import _children, batched_collect_leaves
from ..tree.octree import LinkedOctree

__all__ = ["gravity_monopole"]

# most (group, node) monopoles evaluated at once, times the group size
MONO_CHUNK = 1 << 24


def _images(box: Box, fdt, dev):
    """(periodic flags, L, 1/L) as (3,) tensors when a dim is periodic, else None."""
    if not any(box.periodic_mask):
        return None
    lengths = box.lengths.to(device=dev, dtype=fdt)
    return torch.as_tensor(box.periodic_mask, dtype=fdt, device=dev), lengths, 1.0 / lengths


def _nearest(d: torch.Tensor, axis: int, images) -> torch.Tensor:
    if images is None:
        return d
    pm, lengths, il = images
    return d - pm[axis] * lengths[axis] * torch.round(d * il[axis])


def _pull(dx, dy, dz, gm, eps2: float, live=None):
    """(w dx, w dy, w dz) with w = gm / (|d|^2 + eps2)^(3/2): the softened
    pull of masses times G, gm, along displacements d; 0 where live is
    False."""
    r2 = dx * dx + dy * dy + dz * dz + eps2
    w = gm * (torch.rsqrt(r2) / r2)
    if live is not None:
        w = torch.where(live, w, 0.0)
    return w * dx, w * dy, w * dz


class _Targets(NamedTuple):
    """Target groups: coordinates (n_groups, group_size), 0 past n, the
    valid slots, and the groups' bounding-box centres and half sizes."""

    gx: torch.Tensor
    gy: torch.Tensor
    gz: torch.Tensor
    valid: torch.Tensor
    center: torch.Tensor
    size: torch.Tensor


def _targets(x, y, z, n: int, group_size: int) -> _Targets:
    n_groups = -(-n // group_size)
    pad = n_groups * group_size - n

    def rows(a):
        a = a[:n]
        return (torch.cat([a, a.new_zeros(pad)]) if pad else a).reshape(n_groups, group_size)

    gx, gy, gz = rows(x), rows(y), rows(z)
    lane = torch.arange(group_size, device=x.device)
    valid = torch.arange(n_groups, device=x.device)[:, None] * group_size + lane < n
    big = float(np.finfo(np.float32).max)
    gmin = torch.stack([torch.where(valid, a, big).amin(dim=1) for a in (gx, gy, gz)], -1)
    gmax = torch.stack([torch.where(valid, a, -big).amax(dim=1) for a in (gx, gy, gz)], -1)
    return _Targets(gx, gy, gz, valid, (gmin + gmax) * 0.5, (gmax - gmin) * 0.5)


def _monopoles(tree: LinkedOctree, centers, mac_fails, tg: _Targets, images, G: float, eps2: float):
    """(3, n_groups, group_size) accelerations from the monopoles: the
    children that pass the MAC below nodes that fail it, walked breadth
    first over (group, node) pairs; a root that passes gives one."""
    n_groups, group_size = tg.gx.shape
    dev = tg.gx.device
    acc = torch.zeros((3, n_groups, group_size), dtype=tg.gx.dtype, device=dev)

    def add(q, node):
        step = max(1, MONO_CHUNK // group_size)
        for lo in range(0, q.numel(), step):
            qq, cm = q[lo:lo + step], centers[node[lo:lo + step]]
            d = [_nearest(cm[:, a, None] - g[qq], a, images) for a, g in enumerate((tg.gx, tg.gy, tg.gz))]
            for a, f in enumerate(_pull(*d, G * cm[:, 3, None].abs(), eps2)):
                acc[a].index_add_(0, qq, f)

    q_ids = torch.arange(n_groups, device=dev)
    root = torch.zeros_like(q_ids)
    root_fail = mac_fails(q_ids, root)
    fq = q_ids[root_fail & (tree.child_offsets[0] > 0)]
    fnode = torch.zeros_like(fq)
    while fq.numel() > 0:
        next_q, next_node = [], []
        for q, cc in _children(tree.child_offsets, fq, fnode):
            fails = mac_fails(q, cc)
            add(q[~fails], cc[~fails])
            push = fails & (tree.child_offsets[cc] != 0)
            next_q.append(q[push])
            next_node.append(cc[push])
        fq, fnode = torch.cat(next_q), torch.cat(next_node)
    add(q_ids[~root_fail], root[~root_fail])  # tiny systems
    return acc


def _p2p_sums(acc, x, y, z, m, tree: LinkedOctree, layout, p2p_leaves, n_p2p, tg: _Targets, images, G: float,
              eps2: float, cand_cap: int, chunk: int) -> torch.Tensor:
    """Add the direct sums over the P2P leaves' particles into acc: the
    candidates flattened per group (at most cand_cap) and tested in
    chunks of groups. Returns each group's candidate count."""
    n_groups, group_size = tg.gx.shape
    leaf_cap = p2p_leaves.shape[1]
    dev = x.device
    leaf_idx = torch.where(p2p_leaves >= 0, tree.internal_to_leaf[torch.clamp(p2p_leaves, min=0)], 0)
    k_valid = torch.arange(leaf_cap, device=dev) < torch.clamp(n_p2p, max=leaf_cap)[:, None]
    starts = layout[leaf_idx]
    lens = torch.where(k_valid, layout[leaf_idx + 1] - starts, 0)
    inc = torch.cumsum(lens, dim=1)
    total = inc[:, -1]
    jj = torch.arange(cand_cap, device=dev)
    lane = torch.arange(group_size, device=dev)
    for s in range(0, n_groups, chunk):
        e = min(n_groups, s + chunk)
        seg = torch.clamp(torch.searchsorted(inc[s:e], jj.expand(e - s, cand_cap).contiguous(), right=True),
                          max=leaf_cap - 1)
        exc = torch.gather(inc[s:e], 1, seg) - torch.gather(lens[s:e], 1, seg)
        ok = jj < torch.clamp(total[s:e], max=cand_cap)[:, None]
        ci = torch.where(ok, torch.gather(starts[s:e], 1, seg) + (jj - exc), 0)
        d = [_nearest(c[ci][:, None, :] - g[s:e, :, None], a, images)
             for a, (c, g) in enumerate(((x, tg.gx), (y, tg.gy), (z, tg.gz)))]
        tgt = torch.arange(s, e, device=dev)[:, None] * group_size + lane
        live = (ci[:, None, :] != tgt[:, :, None]) & ok[:, None, :] & tg.valid[s:e, :, None]
        for a, f in enumerate(_pull(*d, G * m[ci][:, None, :], eps2, live)):
            acc[a, s:e] += f.sum(dim=-1)
    return total


def gravity_monopole(
    x: torch.Tensor,
    y: torch.Tensor,
    z: torch.Tensor,
    m: torch.Tensor,
    tree: LinkedOctree,
    layout: torch.Tensor,
    centers: torch.Tensor,
    mac_sq: torch.Tensor,
    geo_centers: torch.Tensor,
    geo_sizes: torch.Tensor,
    box: Box,
    G: float = 1.0,
    eps2: float = 1e-8,
    group_size: int = 64,
    leaf_cap: int = 256,
    cand_cap: int = 4096,
    chunk: int = 16,
    n_targets: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Accelerations (ax, ay, az) of SFC-sorted local particles, and an
    overflow.

    centers: (cap_nodes, 4) mass centres (x, y, z, m) per node; mac_sq:
    (cap_nodes,) squared vector-MAC radius per node (macs.hpp:73-97:
    theta enters there). geo_centers and geo_sizes are the JAX
    signature's and are not read, as there. Nodes whose MAC passes for the
    whole target group contribute monopoles; all other mass is summed
    particle by particle through the opened leaves.

    overflow (0-d int64) > 0 when a capacity was short: the largest P2P
    leaf count of a group where it exceeds leaf_cap, or else the largest
    candidate particle count where it exceeds cand_cap (the JAX package
    reports the latter only and silently drops leaves past leaf_cap).
    """
    n = n_targets or x.shape[0]
    tg = _targets(x, y, z, n, group_size)
    images = _images(box, x.dtype, x.device)
    src_center = centers[:, :3]

    def mac_fails(q_ids, node_ids):
        d = min_distance_point_box(src_center[node_ids], tg.center[q_ids], tg.size[q_ids], box)
        return d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2] < mac_sq[node_ids]

    p2p_leaves, n_p2p = batched_collect_leaves(tree.child_offsets, mac_fails, tg.gx.shape[0], leaf_cap)
    acc = _monopoles(tree, centers, mac_fails, tg, images, G, eps2)
    total = _p2p_sums(acc, x, y, z, m, tree, layout, p2p_leaves, n_p2p, tg, images, G, eps2, cand_cap, chunk)

    leaf_ovf = torch.where(n_p2p > leaf_cap, n_p2p, 0).max()
    overflow = torch.where(leaf_ovf > 0, leaf_ovf, torch.where(total > cand_cap, total, 0).max())
    ax, ay, az = (a.reshape(-1)[:n] for a in acc)
    return ax, ay, az, overflow
