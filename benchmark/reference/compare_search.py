"""The comparison that decides `correct` in the cells of the neighbour
search (traffic `search`): one step's outputs of the program against the
plain reference of the same step.

The program's outputs are those of compare.py's cells plus the
neighbour lists: per buffer slot the particle id, the SFC key, the
position, the neighbour count and a row of ng_max neighbour slots, the
owned range and the global octree. The reference works the step out
again from the sample the harness made from the seed: the positions by
id after that many drift steps, their keys, the cornerstone tree, and
every particle's neighbours by id (neighbor_lists.py).

Each number counts faults, limit 0 (an exact comparison: the program and
the reference make the same float32 tests with the same image):

  position_mismatch, key_mismatch, order_faults, owner_faults,
  tree_mismatch, count_mismatch, failed_steps   as compare.py counts them
  list_mismatch   owned particles whose row, its slots read as ids, is
                  not the reference's: where the reference counts at most
                  ng_max, the row's entries as a set are not its
                  neighbours; where it counts more, they are not ng_max
                  distinct neighbours of its; or the entries are not
                  followed by -1 padding alone (or the id is no id)
"""

from __future__ import annotations

import torch

from .compare import step_numbers as base_numbers

LIMITS = {"position_mismatch": 0, "key_mismatch": 0, "order_faults": 0, "owner_faults": 0,
          "tree_mismatch": 0, "count_mismatch": 0, "list_mismatch": 0, "failed_steps": 0}


def list_faults(rows: torch.Tensor, slot_ids: torch.Tensor, row_ids: torch.Tensor, ref_counts: torch.Tensor,
                ref_lists: torch.Tensor, n: int) -> torch.Tensor:
    """Per row: (rows (m, ng_max) of slot indices, -1 padded; slot_ids the
    id of every buffer slot; row_ids the id each row belongs to) the row
    fails the comparison with the reference's counts and lists by id."""
    m, ng_max = rows.shape
    live = rows >= 0
    n_live = live.sum(dim=1)
    prefix = torch.arange(ng_max, device=rows.device)[None, :] < n_live[:, None]
    bad = (live != prefix).any(dim=1) | (row_ids < 0) | (row_ids >= n)  # a -1 before an entry, or no id
    in_buf = live & (rows < slot_ids.numel())
    ids = torch.where(in_buf, slot_ids[rows.clamp(0, slot_ids.numel() - 1)], -1)
    bad |= (live & ((ids < 0) | (ids >= n))).any(dim=1)  # an entry that is no slot or holds no id
    got = torch.where(live, ids, n).sort(dim=1).values  # the row's ids ascending, n past them
    rid = row_ids.clamp(0, n - 1)
    want_n = ref_counts[rid]
    width = max(ng_max, ref_lists.shape[1], 1)
    pad = lambda a: torch.cat([a, a.new_full((m, width - a.shape[1]), n)], dim=1)  # noqa: E731
    got = pad(got)
    ref = pad(torch.where(ref_lists[rid] >= 0, ref_lists[rid], n))  # ascending, n past the neighbours
    same = (n_live == want_n) & (got == ref).all(dim=1)
    # an overflowing row: ng_max distinct entries, each one of the reference's
    head = got[:, :ng_max]
    found = torch.gather(ref, 1, torch.searchsorted(ref, head).clamp(max=width - 1)) == head
    subset = (n_live == ng_max) & found.all(dim=1) & (head[:, 1:] != head[:, :-1]).all(dim=1)
    return bad | torch.where(want_n <= ng_max, ~same, ~subset)


def step_numbers(out: dict, ref: dict, comm=None, rows_a_chunk: int = 1 << 18) -> dict:
    """The fault counts of one checked step: compare.py's (with the
    reference's counts), and list_mismatch over the owned rows, a chunk
    of rows at a time, summed over the ranks. `ref` holds xyz, keys,
    tree, counts and lists by id."""
    numbers = base_numbers(out, ref, comm)
    n = ref["keys"].numel()
    s, e = int(out["start"]), int(out["end"])
    ids = out["ids"].long()
    faults = torch.zeros((), dtype=torch.int64, device=ids.device)
    for a in range(s, e, rows_a_chunk):
        b = min(e, a + rows_a_chunk)
        faults += list_faults(out["lists"][a:b], ids, ids[a:b], ref["counts"], ref["lists"], n).sum()
    if comm is not None:
        faults = comm.all_reduce(faults, "sum")
    numbers["list_mismatch"] = int(faults)
    return numbers
