"""The step "tiered": the client's timestep of a neighbour count for radii
that vary from particle to particle, through the tiered cell list, and
its comparison with the plain reference:

    drift the particles (by their ids), Domain.sync,
    cell_list_neighbor_counts_tiered over the buffer, reapply_sync of
    the ids, compact_owned into the next input

The configuration gives the tiers' grid levels (`tier_levels`), each
tier's ELL cap at its own level (`tier_caps`) and each tier pair's
candidate cap at the coarser level (`cross_caps`, keyed "a,b"), the
numbers benchmark/tiers.py's rules give at its sample; set-up raises
every cap by 64 while the tiered pass overflows (the Domain does not
report it). In the drained profiled steps of a traced run the step
collects the program's spans around the tiered call, so that the
harness's device time inside `tiered.cross` holds the B3 passes' own
launches; the other steps collect nothing.
"""

from __future__ import annotations

import contextlib

import torch

from benchmark import sample
from benchmark.reference.compare import LIMITS, step_numbers
from benchmark.reference.keys import sfc_keys
from benchmark.reference.neighbors_adaptive import neighbor_counts_adaptive, unordered_pairs
from benchmark.reference.octree import cornerstone_tree
from benchmark.tiers import tier_index

__all__ = ["PHASES", "LIMITS", "load_kernels", "setup", "step", "grow", "check"]

# the harness's phases, then the program's spans inside "tiered" (their device-side images are no device operations)
PHASES = ("drift", "sync", "tiered", "carry",
          "tiered.partition", "tiered.pack", "tiered.same", "tiered.cross", "tiered.scatter")
CAP_STEP = 64


def load_kernels(device) -> None:
    """Build (or load) B1's and B3's kernels."""
    from cstone_tpu_torch.ops import stencil

    stencil.load_library()


def setup(rank) -> None:
    cfg = rank.cfg
    rank.levels, rank.tier_caps = tuple(cfg["tier_levels"]), tuple(cfg["tier_caps"])
    rank.cross_caps = {tuple(int(t) for t in k.split(",")): c for k, c in cfg["cross_caps"].items()}


def program_spans(rank):
    """The program's spans, on in the drained profiled steps alone."""
    if not (rank.profiled and rank.spans.drained):
        return contextlib.nullcontext()
    from cstone_tpu_torch.utils import trace

    return trace.collect()


def step(rank):
    from cstone_tpu_torch.traversal import cell_list_neighbor_counts_tiered

    inp, dom = rank.inp, rank.domain
    with rank.phase("drift"):
        d = rank.drift[inp["ids"].clamp(min=0)]
        xyz = sample.drift_step(inp["xyz"], d, rank.sgn, rank.lo, rank.length)
    rank.sgn, rank.k = -rank.sgn, rank.k + 1
    state, res = rank.sync(xyz, inp["h"], inp["n"])
    with rank.phase("tiered"), program_spans(rank):
        counts, c_ovf = cell_list_neighbor_counts_tiered(res.keys, res.x, res.y, res.z, res.h, state.box,
                                                         rank.levels, rank.tier_caps, rank.cross_caps,
                                                         n_valid=res.n_with_halos)
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
    rank.tier_caps = tuple(c + CAP_STEP for c in rank.tier_caps)
    rank.cross_caps = {p: c + CAP_STEP for p, c in rank.cross_caps.items()}


def reference_step(xyz, h, lo: float, length: float, bucket: int, curve: str, levels) -> tuple:
    """The reference's outputs for the positions `xyz` by id, and the
    tiered pass's necessary work: the unordered pairs within 2 max(h),
    those of each tier pair, and the particles of each tier."""
    keys = sfc_keys(*xyz, lo, length, curve)
    tier = tier_index(h, length, levels)
    T = len(levels)
    counts, (a, b) = neighbor_counts_adaptive(*xyz, h, lo, length, tier=tier, n_tiers=T)
    work = {"tiered_pairs": unordered_pairs(a, b),
            "cross_pairs": {f"{p},{q}": unordered_pairs(a, b, (p, q)) for p in range(T) for q in range(p + 1, T)},
            "tier_particles": torch.bincount(tier, minlength=T).tolist()}
    return {"xyz": xyz, "keys": keys, "tree": cornerstone_tree(keys, bucket), "counts": counts}, work


def check(rank, checked: list):
    """Every checked step against the reference, the fault counts summed;
    the tiered pass's necessary work at the last (one rank: every
    particle is owned)."""
    cfg = rank.cfg
    total = dict.fromkeys(LIMITS, 0)
    facts = {}
    for out in checked:
        xyz = sample.positions_after(rank.xyz0, rank.drift, out["k"], rank.lo, rank.length)
        ref, work = reference_step(xyz, rank.h, rank.lo, rank.length, cfg["bucket"], cfg["curve"], rank.levels)
        for k, v in step_numbers(out, ref, rank.comm).items():
            total[k] += v
        facts = {**work, "tiered_particles": int(out["end"]) - int(out["start"])}
        del ref
    return total, facts
