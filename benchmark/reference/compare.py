"""The comparison that decides `correct`: one step's outputs of the
program against the plain reference of the same step.

The harness keeps, for each checked step, what the timed path produced:
the drift count of the step's input, and per buffer slot of the rank the
particle id (carried through the sync by `Domain.reapply_sync`), the
SFC key, the position and the neighbour count, the owned range, and the
global octree. The reference works the step out again from the sample
the harness made from the seed: the positions by id after that many
drift steps, their keys, the cornerstone tree and the neighbour counts.

Each number counts faults, so a sound run reads 0 and the limit of each
is 0 (an exact comparison):

  position_mismatch  owned particles whose position differs from the
                     reference's of their id (or whose id is no id)
  key_mismatch       owned particles whose key differs
  order_faults       neighbouring owned slots out of key order
  owner_faults       ids owned by no rank or by more than one
  tree_mismatch      leaf keys or counts of the global tree that differ
                     (plus the difference in leaf numbers)
  count_mismatch     owned particles whose neighbour count differs
  failed_steps       window steps that overflowed a capacity
"""

from __future__ import annotations

import torch

from .keys import sfc_keys
from .neighbors import neighbor_counts
from .octree import cornerstone_tree

LIMITS = {"position_mismatch": 0, "key_mismatch": 0, "order_faults": 0, "owner_faults": 0,
          "tree_mismatch": 0, "count_mismatch": 0, "failed_steps": 0}


def reference_step(xyz, h, lo: float, length: float, bucket: int, curve: str = "hilbert") -> dict:
    """The reference's outputs for the positions `xyz` by id."""
    keys = sfc_keys(*xyz, lo, length, curve)
    bounds, counts = cornerstone_tree(keys, bucket)
    return {"xyz": xyz, "keys": keys, "tree": (bounds, counts),
            "counts": neighbor_counts(*xyz, h, lo, length)}


def tree_mismatch(keys, counts, ref_keys, ref_counts) -> int:
    m = min(keys.numel(), ref_keys.numel())
    gap = abs(keys.numel() - ref_keys.numel())
    return gap + int((keys[:m] != ref_keys[:m]).sum()) + int((counts[:m - 1].long() != ref_counts[:m - 1]).sum())


def step_numbers(out: dict, ref: dict, comm=None) -> dict:
    """The fault counts of one checked step, summed over the ranks (the
    tree, the same on every rank, is counted once)."""
    n = ref["keys"].numel()
    s, e = int(out["start"]), int(out["end"])
    ids = out["ids"][s:e].long()
    known = (ids >= 0) & (ids < n)
    idc = ids.clamp(0, n - 1)
    pos_bad = ~known
    for c, rc in zip(out["xyz"], ref["xyz"]):
        pos_bad |= c[s:e] != rc[idc]
    keys = out["keys"][s:e]
    local = torch.stack([
        pos_bad.sum(),
        ((keys != ref["keys"][idc]) | ~known).sum(),
        (keys[1:] < keys[:-1]).sum(),
        ((out["counts"][s:e].long() != ref["counts"][idc]) | ~known).sum(),
    ])
    owners = torch.zeros(n, dtype=torch.int64, device=ids.device).index_add_(
        0, idc[known], torch.ones_like(idc[known]))
    tk, tc, nn = out["tree"]
    tm = torch.tensor(tree_mismatch(tk[:nn + 1], tc[:nn], *ref["tree"]), device=ids.device)
    if comm is not None:
        local = comm.all_reduce(local, "sum")
        owners = comm.all_reduce(owners, "sum")
        tm = comm.all_reduce(tm, "max")
    pos, key, order, count = (int(v) for v in local.tolist())
    return {"position_mismatch": pos, "key_mismatch": key, "order_faults": order,
            "owner_faults": int((owners != 1).sum()), "tree_mismatch": int(tm), "count_mismatch": count}
