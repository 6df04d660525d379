"""The step "density": the SPH client's timestep of a density with
per-particle masses, through the cell list, and its comparison with the
plain reference:

    drift the particles (by their ids), Domain.sync, reapply_sync of the
    masses, models.sph.sph_density through the cell list (B2 with the
    mass plane), reapply_sync of the ids, compact_owned of the ids,
    positions, h and masses into the next input

The harness then reads the sync's overflow and the cell list's once a
step. The configuration gives the cell list's grid (`cell_level`) and
its ELL cap (`cell_cap`), which set-up grows by 64 while the cell list
overflows (the Domain does not report it).

The masses are data, as a model's random weights are: one float32 a
particle, uniform in [0.5, 1.5] / n by id, drawn from the
configuration's `sample_seed` (total mass about 1, SPH-EXA's
normalisation). They are unequal so that a sum that took the wrong
end's mass, or dropped the mass plane, fails the comparison; the work
is the same either way (one plane read, one product at each end).

In the drained profiled steps of a traced run the step collects the
program's spans around the density, so that the harness's device time
inside `density.pass` holds B2's own launches; the other steps collect
nothing.
"""

from __future__ import annotations

import contextlib
import sys

import torch

from benchmark import sample
from benchmark.reference.compare_density import LIMITS, density_bound, step_numbers
from benchmark.reference.density import sph_density as reference_density
from benchmark.reference.keys import sfc_keys
from benchmark.reference.octree import cornerstone_tree

__all__ = ["PHASES", "LIMITS", "load_kernels", "setup", "step", "grow", "check", "masses"]

# the harness's phases, then the program's spans inside "density" (their device-side images are no device operations)
PHASES = ("drift", "sync", "density", "carry", "density.pack", "density.pass", "density.scatter")
CAP_STEP = 64
MASS_STREAM = 0x4D415353  # the masses' generator: sample_seed ^ this, apart from the positions' and drift's


def masses(cfg: dict, device) -> torch.Tensor:
    """(n,) float32 masses by particle id, uniform in [0.5, 1.5] / n."""
    n = cfg["n"]
    g = sample.generator(cfg["sample_seed"] ^ MASS_STREAM, device)
    return (0.5 + torch.rand(n, generator=g, device=device, dtype=torch.float32)) / float(n)


def load_kernels(device) -> None:
    """Build (or load) B2's kernel."""
    from cstone_tpu_torch.ops import stencil

    stencil.load_library()


def setup(rank) -> None:
    rank.level, rank.cell_cap = rank.cfg["cell_level"], rank.cfg["cell_cap"]
    rank.mass = masses(rank.cfg, rank.device)


def program_spans(rank):
    """The program's spans, on in the drained profiled steps alone."""
    if not (rank.profiled and rank.spans.drained):
        return contextlib.nullcontext()
    from cstone_tpu_torch.utils import trace

    return trace.collect()


def step(rank):
    from cstone_tpu_torch.models import sph_density

    inp, dom = rank.inp, rank.domain
    if "m" not in inp:  # a fresh input (harness.Rank.build) has no masses: they follow its ids
        inp["m"] = rank.mass[inp["ids"].clamp(min=0)]
    with rank.phase("drift"):
        d = rank.drift[inp["ids"].clamp(min=0)]
        xyz = sample.drift_step(inp["xyz"], d, rank.sgn, rank.lo, rank.length)
    rank.sgn, rank.k = -rank.sgn, rank.k + 1
    state, res = rank.sync(xyz, inp["h"], inp["n"])
    with rank.phase("density"), program_spans(rank):
        m = dom.reapply_sync(res, inp["m"])
        rho, d_ovf = sph_density(dom, res, state.box, m, cell_level=rank.level, cell_cap=rank.cell_cap)
    with rank.phase("carry"):
        rid = dom.reapply_sync(res, inp["ids"])
        co = dom.compact_owned
        rank.inp = {"xyz": tuple(co(res, c) for c in (res.x, res.y, res.z)), "h": co(res, res.h),
                    "m": co(res, m), "ids": co(res, rid), "n": res.end_index - res.start_index}
    rank.state = state
    tree = state.global_tree
    out = {"k": rank.k, "ids": rid, "keys": res.keys, "xyz": (res.x, res.y, res.z), "rho": rho,
           "start": res.start_index, "end": res.end_index, "tree": (tree.keys, tree.counts, tree.n_nodes)}
    return out, res, d_ovf


def grow(rank) -> None:
    rank.cell_cap += CAP_STEP


def reference_step(xyz, h, m, lo: float, length: float, bucket: int, curve: str) -> dict:
    """The reference's outputs for the positions `xyz`, radii `h` and
    masses `m` by id: keys, the cornerstone tree, the densities and each
    particle's neighbours with q < 2 (near) and q < 1 (inner)."""
    keys = sfc_keys(*xyz, lo, length, curve)
    rho, near, inner = reference_density(*xyz, h, m, lo, length)
    return {"xyz": xyz, "keys": keys, "tree": cornerstone_tree(keys, bucket), "rho": rho, "near": near,
            "inner": inner}


def check(rank, checked: list):
    """Every checked step against the reference, the fault counts summed;
    the density pass's necessary work at the last (rank 0's owned
    particles: the unordered pairs within 2h, the ends with q < 2 and
    with q < 1, the particles)."""
    cfg = rank.cfg
    total = dict.fromkeys(LIMITS, 0)
    facts = {}
    for out in checked:
        xyz = sample.positions_after(rank.xyz0, rank.drift, out["k"], rank.lo, rank.length)
        ref = reference_step(xyz, rank.h, rank.mass, rank.lo, rank.length, cfg["bucket"], cfg["curve"])
        for k, v in step_numbers(out, ref, rank.comm).items():
            total[k] += v
        s, e = int(out["start"]), int(out["end"])
        own = out["ids"][s:e].long().clamp(0, cfg["n"] - 1)
        gap = (out["rho"][s:e].double() - ref["rho"][own].double()).abs() / density_bound(ref["rho"][own],
                                                                                          ref["near"][own])
        print(f"benchmark: step {out['k']}: the densities' largest gap from the reference is "
              f"{float(gap.max()):.4g} of its bound", file=sys.stderr, flush=True)
        near, inner = float(ref["near"][own].sum()), float(ref["inner"][own].sum())
        facts = {"density_pairs": near / 2.0, "density_near_ends": near, "density_inner_ends": inner,
                 "density_particles": e - s}
        del ref
    return total, facts
