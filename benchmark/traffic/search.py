"""The step "search": the client's timestep of the octree neighbour search
that writes each particle's neighbour list (cornerstone-octree's
neighbor_driver.cu and SPH-EXA's first step of its density and force
loops), and its comparison with the plain reference:

    drift the particles (by their ids), Domain.sync, Domain.ns_view and
    find_neighbors with index lists (ng_max a row) on the default route
    over every owned particle, reapply_sync of the ids, compact_owned
    into the next input

The harness then reads the sync's overflow once a step. The lists stay
on the card, as neighbor_driver.cu leaves them. The configuration gives
ng_max, the group size and the traversal's capacities (cand_leaf_cap,
frontier_cap, run_cap); set-up doubles the one that find_neighbors names
when check_nb_stats raises (any other capacity it names starts from
find_neighbors' default), and a window step that overflows one fails.
One rank: its targets are the slots [0, n).

In the drained profiled steps of a traced run the step collects the
program's spans around the search, so that the harness's device time
inside `neighbors.pass` holds B5's list launch; the other steps collect
nothing.
"""

from __future__ import annotations

import contextlib
import inspect
import sys

import torch

from benchmark import sample
from benchmark.reference.compare_search import LIMITS, step_numbers
from benchmark.reference.keys import sfc_keys
from benchmark.reference.neighbor_lists import neighbor_lists
from benchmark.reference.octree import cornerstone_tree

__all__ = ["PHASES", "LIMITS", "load_kernels", "setup", "step", "grow", "check", "reference_step"]

# the harness's phases, then the program's spans inside "search" (their device-side images are no device operations)
PHASES = ("drift", "sync", "search", "carry", "neighbors.groups", "neighbors.runs", "neighbors.pass",
          "neighbors.check")
CAPS = ("cand_leaf_cap", "frontier_cap", "run_cap")


def load_kernels(device) -> None:
    """Build (or load) B5's kernels. A program without B5's list mode,
    which the cell runs, stops here (its lists would take the PyTorch
    route)."""
    from cstone_tpu_torch.ops.neighbors_v2 import load_library, pairwise_list_runs  # noqa: F401

    load_library()


def setup(rank) -> None:
    if rank.ranks != 1:
        raise SystemExit("the search step runs one rank")
    rank.nb_caps = {k: rank.cfg[k] for k in CAPS}
    rank.short = None


def program_spans(rank):
    """The program's spans, on in the drained profiled steps alone."""
    if not (rank.profiled and rank.spans.drained):
        return contextlib.nullcontext()
    from cstone_tpu_torch.utils import trace

    return trace.collect()


def search(rank, res, box):
    """(counts, lists, None), or where a capacity overflowed (zeros, -1
    rows, the capacity's name)."""
    from cstone_tpu_torch.traversal import find_neighbors

    cfg = rank.cfg
    view = rank.domain.ns_view(res, box)
    try:
        counts, lists = find_neighbors(res.x, res.y, res.z, res.h, view, box, ng_max=cfg["ng_max"],
                                       group_size=cfg["group_size"], with_indices=True, n_targets=cfg["n"],
                                       **rank.nb_caps)
        return counts, lists, None
    except RuntimeError as err:
        short = getattr(err, "cap", None)  # check_nb_stats' CapacityError names the capacity
        if short is None:
            raise
        n = res.x.shape[0]
        return (torch.zeros(n, dtype=torch.int32, device=res.x.device),
                torch.full((n, cfg["ng_max"]), -1, dtype=torch.int64, device=res.x.device), short)


def step(rank):
    inp, dom = rank.inp, rank.domain
    with rank.phase("drift"):
        d = rank.drift[inp["ids"].clamp(min=0)]
        xyz = sample.drift_step(inp["xyz"], d, rank.sgn, rank.lo, rank.length)
    rank.sgn, rank.k = -rank.sgn, rank.k + 1
    state, res = rank.sync(xyz, inp["h"], inp["n"])
    with rank.phase("search"), program_spans(rank):
        counts, lists, rank.short = search(rank, res, state.box)
    with rank.phase("carry"):
        rid = dom.reapply_sync(res, inp["ids"])
        co = dom.compact_owned
        rank.inp = {"xyz": tuple(co(res, c) for c in (res.x, res.y, res.z)), "h": co(res, res.h),
                    "ids": co(res, rid), "n": res.end_index - res.start_index}
    rank.state = state
    tree = state.global_tree
    out = {"k": rank.k, "ids": rid, "keys": res.keys, "xyz": (res.x, res.y, res.z), "counts": counts,
           "lists": lists, "start": res.start_index, "end": res.end_index,
           "tree": (tree.keys, tree.counts, tree.n_nodes)}
    own = None if rank.short is None else torch.ones((), dtype=torch.int64, device=res.overflow.device)
    return out, res, own


def grow(rank) -> None:
    """Double the capacity the last step's search named."""
    from cstone_tpu_torch.traversal import find_neighbors

    name = rank.short
    start = rank.nb_caps.get(name, inspect.signature(find_neighbors).parameters[name].default)
    rank.nb_caps[name] = 2 * start
    print(f"benchmark: {name} grown to {rank.nb_caps[name]}", file=sys.stderr, flush=True)


def reference_step(xyz, h, lo: float, length: float, bucket: int, curve: str) -> dict:
    """The reference's outputs for the positions `xyz` and radii `h` by
    id: keys, the cornerstone tree, and every particle's neighbour count
    and list."""
    keys = sfc_keys(*xyz, lo, length, curve)
    counts, lists = neighbor_lists(*xyz, h, lo, length)
    return {"xyz": xyz, "keys": keys, "tree": cornerstone_tree(keys, bucket), "counts": counts, "lists": lists}


def check(rank, checked: list):
    """Every checked step against the reference, the fault counts summed;
    the search's necessary work at the last (the neighbours the reference
    counts for the owned particles, the particles, the row width)."""
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
        facts = {"search_hits": float(ref["counts"][own].sum()), "search_particles": e - s,
                 "search_ng_max": cfg["ng_max"]}
        del ref
    return total, facts
