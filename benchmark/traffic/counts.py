"""The step "counts": the client's timestep of a cell-list neighbour count,
the same on one rank or many, and its comparison with the plain
reference. A traffic mix names it under "step"; the harness loads this
file by that name and drives it in set-up and in the window:

    drift the rank's particles (by their ids), Domain.sync,
    cell_list_neighbor_counts over the rank's buffer, reapply_sync of
    the ids, compact_owned into the next input

The harness then reads the sync's overflow and the cell list's once a
step. The configuration gives the cell list's grid (`cell_level`) and
its ELL cap (`cell_cap`), which set-up grows by 64 while the cell list
overflows (the Domain does not report it).

A step module holds: PHASES (its spans, in order), load_kernels(device),
setup(rank), step(rank) -> (outputs, SyncResult, own overflow or None),
grow(rank), LIMITS and check(rank, outputs) -> (numbers, facts).
"""

from __future__ import annotations

from benchmark import sample
from benchmark.reference.compare import LIMITS, reference_step, step_numbers

__all__ = ["PHASES", "LIMITS", "load_kernels", "setup", "step", "neighbor_pass", "grow", "check"]

PHASES = ("drift", "sync", "celllist", "carry")
CAP_STEP = 64


def load_kernels(device) -> None:
    """Build (or load) the neighbour pass's kernels."""
    from cstone_tpu_torch.ops import stencil

    stencil.load_library()


def setup(rank) -> None:
    rank.level, rank.cell_cap = rank.cfg["cell_level"], rank.cfg["cell_cap"]


def neighbor_pass(rank, res, state):
    from cstone_tpu_torch.traversal import cell_list_neighbor_counts

    return cell_list_neighbor_counts(res.keys, res.x, res.y, res.z, res.h, state.box, rank.level,
                                     rank.cell_cap, n_valid=res.n_with_halos)


def step(rank):
    inp, dom = rank.inp, rank.domain
    with rank.phase("drift"):
        d = rank.drift[inp["ids"].clamp(min=0)]
        xyz = sample.drift_step(inp["xyz"], d, rank.sgn, rank.lo, rank.length)
    rank.sgn, rank.k = -rank.sgn, rank.k + 1
    state, res = rank.sync(xyz, inp["h"], inp["n"])
    with rank.phase("celllist"):
        counts, c_ovf = neighbor_pass(rank, res, state)
    with rank.phase("carry"):
        rid = dom.reapply_sync(res, inp["ids"])
        co = dom.compact_owned
        rank.inp = {"xyz": tuple(co(res, c) for c in (res.x, res.y, res.z)), "h": co(res, res.h),
                    "ids": co(res, rid), "n": res.end_index - res.start_index}
    rank.state = state
    tree = state.global_tree
    out = {"k": rank.k, "ids": rid, "keys": res.keys, "xyz": (res.x, res.y, res.z), "counts": counts,
           "start": res.start_index, "end": res.end_index, "tree": (tree.keys, tree.counts, tree.n_nodes)}
    return out, res, c_ovf


def grow(rank) -> None:
    rank.cell_cap += CAP_STEP


def check(rank, checked: list):
    """Every checked step against the reference; the fault counts summed,
    and the neighbour pass's necessary work (the unordered pairs within
    2h of this rank's owned particles, and their number) at the last."""
    cfg = rank.cfg
    total = dict.fromkeys(LIMITS, 0)
    facts = {}
    for out in checked:
        xyz = sample.positions_after(rank.xyz0, rank.drift, out["k"], rank.lo, rank.length)
        ref = reference_step(xyz, rank.h, rank.lo, rank.length, cfg["bucket"], cfg["curve"])
        for k, v in step_numbers(out, ref, rank.comm).items():
            total[k] += v
        s, e = int(out["start"]), int(out["end"])
        own = out["ids"][s:e].long().clamp(0, cfg["n"] - 1)
        facts = {"nbpass_pairs": float(ref["counts"][own].sum()) / 2.0, "nbpass_particles": e - s}
        del ref
    return total, facts
