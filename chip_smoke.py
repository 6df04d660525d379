#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (cstone_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure raises and exits non-zero:
  1. card: nvidia-smi name and power limit, torch's device name; refuses
     to run without CUDA (there is no CPU fallback);
  2. build: compiles the four kernel sources (csrc/stencil_sym.cu,
     stencil.cu, neighbors_v2.cu, neighbors_v1.cu) with nvcc, one process
     each, all started together, and prints ptxas' registers, shared
     memory and spills per kernel;
  3. kernel vs plain version on the card: B1/B2 (the half-stencil kernel)
     at levels 3 and 5, cap 64, periodic and open, uniform and Gaussian,
     B1 launched twice (the same counts each launch); B1 on a pair across
     each periodic edge whose d2 differs between its ends; B1/B2 at level 2 with caps
     1088 and 2496 (densest cell above 1024); B3 (one symmetric launch for
     both sides) at levels 2 and 3 with unequal caps, its lanes on each
     table in turn, one lane-table cap above 1024, periodic and open,
     count and density with masses, and on the wrap pair split across the
     two tables; B4 against impl="xla"; B5 and B6 on the arguments
     find_neighbors launched them with after Domain.sync of 16K uniform
     and Gaussian particles with the test_neighbors.py group settings; B5
     on tiles that need no image, one hoisted shift or the per-pair image,
     with pairs at exactly +-L/2 (mixed_image_runs).
     Counts bit-equal, density within rtol 1e-5;
  4. main path of the cell list at full size: 1M uniform particles in the
     periodic unit box, h = 0.012, bucket 64, cell level 5, ELL cap 64.
     Domain.sync + cell_list_neighbor_counts for 1 warm and 10 drift
     steps, then 3 steps of the SPH density cell path. Checks overflow,
     mean neighbour count 57.9 +- 0.5, mean density within 2% of
     1 + 1/(pi h^3 n), the cornerstone invariants, and that B1/B2
     launched; on the last step's inputs times B1/B2 against the
     one-sided kernel (csrc/stencil.cu, self mask on) in turns (old, new,
     new, old) and against their plain versions, with each kernel's bound;
  5. path A, the tiered adaptive-h cell list: 1M Gaussian particles (seed
     42) in the periodic unit box, h = adaptive_h(pos, 100 neighbours),
     bucket 64, tiers from choose_tier_levels(max_tiers=3) and tier_caps
     (slack 1.3). Domain.sync + cell_list_neighbor_counts_tiered for 1
     warm and 3 drift steps; checks overflow 0, at least 2 tiers, B1
     launched and B3 launched once per tier pair and step, every B1 and B3
     launch of the last step bit-equal to its plain version on the
     arguments it was given and timed on them in device time (B3 also in turns old, new, new, old against the two one-sided
     launches of csrc/stencil.cu it replaced), and the tiered counts
     bit-equal to one single-level pass at levels[0] by impl="pallas"
     (B1) and by impl="pallas_asym" (B4, its launches counted around that
     pass alone), the latter also bit-equal to its plain version;
  6. path B, the octree neighbor search: 1M uniform particles, periodic
     unit box, h = 0.012, bucket 64. Domain.sync -> Domain.ns_view ->
     find_neighbors with bench.py's settings (cand_cap raised to 4096 for
     the "v1" route), route "v2" (B5) for 3 drift
     steps, then one "v1" pass (B6); checks the mean count 57.9 +- 0.5,
     that v2, v1 and the cell list agree on the same sync except for at
     most 10 particles differing by 1 (threshold flips across the
     periodic wrap: each route computes the image its own way), and the
     last B5 and B6 launches bit-equal to their plain versions on the
     arguments they were given.
Each path's launch counts are set to 0 just before it is driven and read
just after. Every kernel's bound is the larger of its FP32 operations over
67 TFLOP/s and its bytes over 3.35 TB/s, counted from that run's inputs;
no single PyTorch call computes any of these functions, so library_ms is
null. Kernel-vs-plain checks of phases 3, 5 and 6 take the
arguments and results of the path's own launches (record_launches).
Kernel times: CUDA events around back-to-back launches (phases 4 and 6);
in phase 5, whose short launches the host could not keep the card busy
with, device time: CUDA events around launches queued behind a spin
kernel (device_time_ms); plain times: one call. The
line before last is the kernel summary JSON; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

N = 1_000_000
SEED = 42
H = 0.012
BUCKET = 64
LEVEL = 5
CAP = 64
DRIFT_STEPS = 10
SPH_STEPS = 3
TIERED_STEPS = 3
FIND_STEPS = 3
# find_neighbors settings of bench.py (:535-537, :654, :670-671), except
# cand_cap: the "v1" route needs 3676 flattened candidates per group at
# this sync, above bench.py's 3584; bench.py's tile=1024 has no
# counterpart in the port (the B5 kernel tiles by the group size)
NB_KW = dict(group_size=256, cand_leaf_cap=320, cand_cap=4096, run_cap=48, frontier_cap=256)
# the group settings of tests/test_neighbors.py
NB_TEST_KW = dict(group_size=32, cand_cap=8192, cand_leaf_cap=640)

STENCIL_SRC = "cstone_tpu_torch/csrc/stencil.cu"
SYM_SRC = "cstone_tpu_torch/csrc/stencil_sym.cu"
KERNELS = {  # name: (source, TPU kernel it replaces)
    "stencil_counts": (SYM_SRC, "cstone_tpu/ops/pallas_stencil.py:295"),
    "stencil_density": (SYM_SRC, "cstone_tpu/ops/pallas_stencil.py:295"),
    "stencil_cross": (SYM_SRC, "cstone_tpu/ops/pallas_stencil.py:589"),
    "stencil_counts_asym": (STENCIL_SRC, "cstone_tpu/ops/pallas_stencil.py:149"),
    "pairwise_count_runs": ("cstone_tpu_torch/csrc/neighbors_v2.cu",
                            "cstone_tpu/ops/pallas_neighbors_v2.py:103"),
    "pairwise_count": ("cstone_tpu_torch/csrc/neighbors_v1.cu",
                       "cstone_tpu/ops/pallas_neighbors.py:31"),
}


# H100 SXM peaks (NVIDIA data sheet, 700 W): FP32 outside the tensor cores
# and HBM3 bandwidth; a kernel's bound is the larger of flops / FP32_PEAK
# and bytes / HBM_PEAK for the work of this run's inputs
FP32_PEAK = 67e12
HBM_PEAK = 3.35e12
# FP32 operations the functions need: d2 of a pair = 3 sub + 3 mul + 2 add,
# once per pair; one compare at each end that tests it (count: d2 < r2;
# density: the q < 2 cut-off). The run-streaming route's floor(d/L + 1/2)
# image is charged nothing: it is constant over nearly every tile, so B5
# takes it once per tile and axis, not per test. Density, at each end with
# q < 2 only (W is 0 beyond): sqrt, scale by 1/h, the q < 1 compare, the
# 1 <= q < 2 branch (2 - q, two muls, 0.25 *) and the sum; the q < 1
# branch takes two more (six), a per-slot mass one more
OPS_D2, OPS_CMP = 8, 1
OPS_NEAR, OPS_INNER = 8, 2


def bound(flops, nbytes):
    """(bound_ms, bound_by) of work of `flops` FP32 operations moving
    `nbytes` bytes."""
    t_ops, t_bytes = flops / FP32_PEAK * 1e3, nbytes / HBM_PEAK * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def stencil_pairs(valid_t, valid_c, periodic, level, same):
    """Pairs of valid slots one stencil pass must test: unordered pairs of
    one table (same=True: centre cell i < j plus the 13 forward cells), or
    every target-candidate pair of two tables over the 27 cells. The cell
    walk is ops/stencil.py's: its directions, rolls and open-edge test."""
    from cstone_tpu_torch.ops import stencil

    D = 1 << level
    nt, nc = (v.sum(dim=1).double().reshape(D, D, D, 1) for v in (valid_t, valid_c))

    def seen(n, d):  # n of cell c + d, 0 beyond an open edge
        out = stencil._roll3(n, *d)
        for axis, dd in enumerate(d):
            if dd != 0 and not periodic[axis]:
                out = out * (stencil._wrap_over(D, dd, axis, n.device) == 0)
        return out

    dirs = stencil._directions()
    if not same:
        return float(sum((nt * seen(nc, d)).sum() for d in dirs))
    return float((nt * (nt - 1) / 2).sum() + sum((nt * seen(nt, d)).sum() for d in dirs[14:]))


def stencil_bytes(valid, n_planes):
    """Bytes a stencil function must move for one ELL table: valid read
    and one 4-byte result written per slot, and the n_planes 4-byte
    planes read at valid slots only (nothing reads an empty slot)."""
    return valid.numel() * (1 + 4) + 4 * n_planes * float(valid.sum())


def stencil_bound(valid, periodic, level, ends=None, mass=False):
    """Bound of B1 (ends None) or B2 on one ELL table. B2 takes ends =
    (ends with q < 2, ends with q < 1): the ordered pairs whose target end
    adds a spline term, and those on its inner branch."""
    pairs = stencil_pairs(valid, valid, periodic, level, same=True)
    ops = pairs * (OPS_D2 + 2 * OPS_CMP)
    if ends is None:
        return bound(ops, stencil_bytes(valid, 4))
    near, inner = ends
    ops += near * (OPS_NEAR + int(mass)) + inner * OPS_INNER
    return bound(ops, stencil_bytes(valid, 5 if mass else 4))


def density_ends(px, py, pz, ph, valid, L, flags, level):
    """(ends with q < 2, ends with q < 1) of the density pass, counted by
    the plain stencil at r2 = (2h)^2 and h^2."""
    import torch

    from cstone_tpu_torch.ops import stencil

    return tuple(int(stencil.stencil_counts_plain(
        px, py, pz, torch.where(valid, (f * ph) * (f * ph), -1.0), valid, L, flags, level).sum())
        for f in (2.0, 1.0))


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def phase(name):
    print(f"== {name}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps):
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_time_ms(fn, reps):
    """Device time of one call of fn, without the host's issue time: reps
    calls after a warm-up are queued behind a spin kernel on the stream, and
    CUDA events time them on the card from the first call's start to the
    last one's end. CUDA events around calls issued to an idle card measure
    the host's issue time instead where that is the longer, as it is for the
    short launches of path A. The spin is lengthened until it outlasts the
    issue of all reps calls, which the start event, still pending when the
    last call is issued, proves. fn must not wait for the card."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for spin in (1 << 24, 1 << 26, 1 << 28, 1 << 30):  # clock cycles, 8.5 ms up at 1.98 GHz
        torch.cuda._sleep(spin)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        queued = not start.query()
        end.synchronize()
        if queued:
            return start.elapsed_time(end) / reps
    raise RuntimeError("chip_smoke check failed: the calls' issue outlasted every spin kernel")


def timed_ms(fn):
    """(result, ms) of one call, CUDA events around it."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def plain_of(name):
    from cstone_tpu_torch.ops import neighbors_v1, neighbors_v2, stencil

    mod = {"pairwise_count_runs": neighbors_v2, "pairwise_count": neighbors_v1}.get(name, stencil)
    return getattr(mod, name + "_plain")


def all_launches() -> dict:
    from cstone_tpu_torch.ops import neighbors_v1, neighbors_v2, stencil

    return {**stencil.launches(), **neighbors_v2.launches(), **neighbors_v1.launches()}


def reset_all_launches() -> None:
    from cstone_tpu_torch.ops import neighbors_v1, neighbors_v2, stencil

    for mod in (stencil, neighbors_v2, neighbors_v1):
        mod.reset_launches()


class Errors:
    """Largest |kernel - plain| per kernel over the phase-3 comparisons."""

    def __init__(self):
        self.max = {k: 0.0 for k in KERNELS}

    def counts(self, name, got, want, what):
        import torch

        check(torch.equal(got, want), f"{name} differs from its plain version ({what})")
        self.max[name] = max(self.max[name], float((got.long() - want.long()).abs().max()))

    def density(self, name, got, want, what):
        import torch

        ok = torch.allclose(got, want, rtol=1e-5, atol=1e-6)
        check(ok, f"{name} differs from its plain version beyond rtol 1e-5 ({what})")
        self.max[name] = max(self.max[name], float((got - want).abs().max()))


# ----------------------------------------------------------------------------
# inputs
# ----------------------------------------------------------------------------

def sorted_sample(dev, n, periodic, gauss, seed, level):
    """Key-sorted sample in the unit box with h in [0.3, 0.5] cell sides and
    a mass in [0.5, 1.5]: (keys, (x, y, z, h, m), box)."""
    import torch

    from cstone_tpu_torch.ops.keys64 import usort
    from cstone_tpu_torch.sfc import compute_sfc_keys, make_box
    from cstone_tpu_torch.utils.workloads import gaussian_coords

    rng = np.random.RandomState(seed)
    if gauss:
        pos = gaussian_coords(n, (0.0, 1.0) * 3, seed=seed)
    else:
        pos = rng.uniform(0.0, 1.0, size=(n, 3)).astype(np.float32)
    h = rng.uniform(0.3, 0.5, size=n).astype(np.float32) / (1 << level)
    m = rng.uniform(0.5, 1.5, size=n).astype(np.float32)
    box = make_box(0.0, 1.0, boundaries=int(periodic), device=dev)
    p = torch.from_numpy(pos).to(dev)
    keys, order = usort(compute_sfc_keys(p[:, 0], p[:, 1], p[:, 2], box, np.uint64))
    cols = tuple(c[order].contiguous() for c in (p[:, 0], p[:, 1], p[:, 2]))
    cols += tuple(torch.from_numpy(a).to(dev)[order] for a in (h, m))
    return keys, cols, box


def ell_inputs(keys, xs, ys, zs, hs, box, level, cap, mass=None, n_valid=None):
    """ELL planes as the main path hands them to the kernels:
    (px, py, pz, ph, r2, pm, valid)."""
    import torch

    from cstone_tpu_torch.traversal import celllist

    perm, _ = celllist.rowmajor_cell_perm(level, device=xs.device)
    fields = (xs, ys, zs, hs) + (() if mass is None else (mass,))
    packed, valid, _, ovf = celllist.ell_pack(keys, perm, fields, cap, level, n_valid=n_valid)
    check(not bool(ovf), f"ELL cap {cap} overflowed at level {level}")
    px, py, pz, ph = packed[:4]
    r2 = torch.where(valid, (2.0 * ph) * (2.0 * ph), -1.0)
    pm = torch.where(valid, packed[4], 0.0) if mass is not None else None
    return px, py, pz, ph, r2, pm, valid


def flags_of(box):
    return tuple(int(b) == 1 for b in box.boundaries)


def compare_stencil(err, planes, box, level, what, asym=False):
    """B1 (and B4) counts and B2 density, kernel vs plain; B1 launched twice
    (integer atomics: the same counts every launch)."""
    from cstone_tpu_torch.ops import stencil

    px, py, pz, ph, r2, pm, valid = planes
    flags, L = flags_of(box), box.lengths
    want = stencil.stencil_counts_plain(px, py, pz, r2, valid, L, flags, level)
    for launch in ("first", "second"):
        err.counts("stencil_counts", stencil.stencil_counts(px, py, pz, r2, valid, L, flags, level),
                   want, f"{what}, {launch} launch")
    if asym:  # B4 against impl="xla", the plain roll stencil
        err.counts("stencil_counts_asym",
                   stencil.stencil_counts_asym(px, py, pz, r2, valid, L, flags, level), want, what)
    for mass in (None, pm):
        err.density("stencil_density",
                    stencil.stencil_density(px, py, pz, ph, valid, L, flags, level, mass),
                    stencil.stencil_density_plain(px, py, pz, ph, valid, L, flags, level, mass),
                    what)


def cross_tables(dev, level, periodic, op, n, frac_b=0.3, seed=3):
    """Two disjoint sets of one Gaussian sample packed at `level` with
    unequal caps (B: a share frac_b of the particles; A: the rest, cap +
    64): [((x, y, z, w, valid), mass)] with w = r2 (count) or h
    (density)."""
    import torch

    from cstone_tpu_torch.ops.keys64 import srl

    keys, cols, box = sorted_sample(dev, n, periodic, True, seed, level)
    in_b = torch.from_numpy(np.random.RandomState(seed).uniform(size=keys.shape[0]) < frac_b).to(dev)
    tables = []
    for sel, extra in ((~in_b, 64), (in_b, 0)):
        occ = int(torch.bincount(srl(keys[sel], 3 * (21 - level))).max())
        cap = 64 * -(-occ // 64) + extra
        px, py, pz, ph, r2, pm, valid = ell_inputs(keys[sel], *(c[sel] for c in cols[:4]), box,
                                                   level, cap, mass=cols[4][sel])
        tables.append(((px, py, pz, r2 if op == "count" else ph, valid), pm))
    return tables, box


def synced_view(dev, n, periodic, gauss, seed=11, bucket=16):
    """Domain.sync of n particles in the unit box, h in [0.01, 0.03] ->
    (x, y, z, h, view, box)."""
    import torch

    from cstone_tpu_torch.domain import Domain
    from cstone_tpu_torch.sfc import make_box
    from cstone_tpu_torch.utils.workloads import gaussian_coords

    rng = np.random.RandomState(seed)
    if gauss:
        pos = gaussian_coords(n, (0.0, 1.0) * 3, seed=seed)
    else:
        pos = rng.uniform(0.0, 1.0, size=(n, 3)).astype(np.float32)
    h = rng.uniform(0.01, 0.03, size=n).astype(np.float32)
    box = make_box(0.0, 1.0, boundaries=int(periodic), device=dev)
    domain = Domain(bucket_size=bucket, tree_capacity=max(1024, 4 * n // bucket), device=dev)
    state = domain.init_state(box=box, boundaries=(int(periodic),) * 3)
    cols = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (pos[:, 0], pos[:, 1], pos[:, 2], h)]
    state, res = domain.sync(state, *cols)
    check(int(res.overflow) == 0, "16K sync overflowed")
    return res.x, res.y, res.z, res.h, domain.ns_view(res, state.box), state.box


# ----------------------------------------------------------------------------
# phase 3
# ----------------------------------------------------------------------------

def kernel_vs_plain_phase(dev, err: Errors):
    """Phase 3: every kernel against its plain version on small grids."""
    import torch

    from cstone_tpu_torch.ops import neighbors_v2, stencil
    from cstone_tpu_torch.ops.cuda_lib import record_launches
    from cstone_tpu_torch.traversal import neighbors
    from cstone_tpu_torch.utils.workloads import (
        mixed_image_runs,
        wrap_threshold_cross,
        wrap_threshold_ell,
    )

    for level, n in ((3, 2500), (5, 150_000)):  # fullest cell stays below cap 64
        for periodic in (True, False):
            for gauss in (False, True):
                keys, cols, box = sorted_sample(dev, n, periodic, gauss, 7, level)
                planes = ell_inputs(keys, *cols[:4], box, level, CAP, mass=cols[4])
                what = f"level {level} n {n} periodic {periodic} gauss {gauss}"
                compare_stencil(err, planes, box, level, what, asym=True)
                print(f"B1/B2/B4 vs plain: {what}: ok", flush=True)

    # a pair across each periodic edge whose d2 differs between its ends,
    # both radii between the two values: each end must test its own d2
    for axis in range(3):
        planes, valid, level, d2_i, d2_j = wrap_threshold_ell(axis)
        px, py, pz, r2 = torch.from_numpy(planes).to(dev)
        valid, L = torch.from_numpy(valid).to(dev), torch.ones(3, device=dev)
        want = stencil.stencil_counts_plain(px, py, pz, r2, valid, L, (True,) * 3, level)
        check(int(want.sum()) == 1, "the wrap case should hold one counted end")
        err.counts("stencil_counts", stencil.stencil_counts(px, py, pz, r2, valid, L, (True,) * 3, level),
                   want, f"wrap pair on axis {axis}, d2 {d2_i!r} / {d2_j!r}")
    print("B1 vs plain: pairs across the periodic wrap with end-dependent d2: ok", flush=True)

    # caps above 1024: level 2, Gaussian, densest cell 1060 (n 16,500) and 2284 (n 35,000)
    for cap, n in ((1088, 16_500), (2496, 35_000)):
        for periodic in (True, False):
            keys, cols, box = sorted_sample(dev, n, periodic, True, 7, 2)
            planes = ell_inputs(keys, *cols[:4], box, 2, cap, mass=cols[4])
            fullest = int(planes[-1].sum(dim=1).max())
            check(fullest > 1024, f"densest cell {fullest} should exceed 1024")
            what = f"level 2 cap {cap} densest cell {fullest} periodic {periodic}"
            compare_stencil(err, planes, box, 2, what)
            print(f"B1/B2 vs plain: {what}: ok", flush=True)

    # B3: one launch for both sides, unequal caps; the kernel puts its lanes
    # on the 70% share, A in the first cases, B in the last, whose densest
    # cell exceeds 1024
    lanes_seen = set()
    for level, n, frac_b in ((2, 20_000, 0.3), (3, 50_000, 0.3), (2, 35_000, 0.7)):
        for periodic in (True, False):
            for op in ("count", "density"):
                ((ta, ma), (tb, mb)), box = cross_tables(dev, level, periodic, op, n, frac_b)
                fullest = int(tb[4].sum(dim=1).max())
                check(frac_b < 0.5 or fullest > 1024, f"densest B cell {fullest} should exceed 1024")
                lanes = "B" if stencil.cross_lanes_on_b(ta[4], tb[4]) else "A"
                check(lanes == ("B" if frac_b > 0.5 else "A"), f"lanes on {lanes}")
                lanes_seen.add(lanes)
                flags = flags_of(box)
                mass = dict(mass_t=ma, mass_c=mb) if op == "density" else {}
                got = stencil.stencil_cross(ta, tb, box.lengths, flags, level, op=op, **mass)
                want = stencil.stencil_cross_plain(ta, tb, box.lengths, flags, level, op=op, **mass)
                what = (f"level {level} n {n} caps {ta[0].shape[1]}/{tb[0].shape[1]} densest B "
                        f"cell {fullest} periodic {periodic} {op}, lanes on {lanes}")
                for g, w in zip(got, want):
                    (err.counts if op == "count" else err.density)("stencil_cross", g, w, what)
                print(f"B3 vs plain: {what}: ok", flush=True)

    check(lanes_seen == {"A", "B"}, f"B3 should run with its lanes on each table: {lanes_seen}")

    # the wrap pair split across the two tables, each end in turn the lane end
    for axis in range(3):
        for swap in (False, True):
            planes, valid_a, valid_b, level, d2_a, d2_b = wrap_threshold_cross(axis, swap)
            px, py, pz, r2 = torch.from_numpy(planes).to(dev)
            ta, tb = ((px, py, pz, r2, torch.from_numpy(v).to(dev)) for v in (valid_a, valid_b))
            L, flags = torch.ones(3, device=dev), (True,) * 3
            want = stencil.stencil_cross_plain(ta, tb, L, flags, level)
            check(sum(int(w.sum()) for w in want) == 1, "the cross wrap case should hold one counted end")
            what = f"cross wrap pair on axis {axis}, d2 {d2_a!r} (A) / {d2_b!r} (B)"
            for g, w in zip(stencil.stencil_cross(ta, tb, L, flags, level), want):
                err.counts("stencil_cross", g, w, what)
    print("B3 vs plain: the wrap pair split across the tables, each end in turn: ok", flush=True)

    # B5 and B6 on the arguments find_neighbors launched them with after Domain.sync
    for periodic in (True, False):
        for gauss in (False, True):
            x, y, z, h, view, box = synced_view(dev, 16_384, periodic, gauss)
            with record_launches() as calls:
                for route in ("v2", "v1"):
                    neighbors.find_neighbors(x, y, z, h, view, box, use_pallas=route, **NB_TEST_KW)
            names = [name for name, _, _ in calls]
            check(names == ["pairwise_count_runs", "pairwise_count"], f"launched {names}")
            what = f"16384 particles periodic {periodic} gauss {gauss}"
            for name, args, got in calls:
                err.counts(name, got, plain_of(name)(*args), what)
            print(f"B5/B6 vs plain: {what}: ok", flush=True)

    # B5 where tiles need no image, one hoisted shift or the per-pair image
    for G, n_groups in ((32, 48), (256, 12)):
        for periodic in (True, False):
            args = tuple(torch.from_numpy(a).to(dev) for a in mixed_image_runs(G, n_groups, periodic))
            want = neighbors_v2.pairwise_count_runs_plain(*args)
            what = f"mixed images, {n_groups} groups of {G}, periodic {periodic}"
            err.counts("pairwise_count_runs", neighbors_v2.pairwise_count_runs(*args), want, what)
            print(f"B5 vs plain: {what}: ok", flush=True)
    torch.cuda.synchronize()


# ----------------------------------------------------------------------------
# phase 4: the cell-list main path
# ----------------------------------------------------------------------------

def cornerstone_ok(tree, n) -> None:
    from cstone_tpu_torch.ops.keys64 import to_numpy

    nn = int(tree.n_nodes)
    keys = to_numpy(tree.keys)[: nn + 1]
    check(keys[0] == 0 and int(keys[-1]) == 1 << 63, "cornerstone tree must span [0, 2^63)")
    d = np.diff(keys)
    check(bool(((d & (d - np.uint64(1))) == 0).all() and (d > 0).all()), "leaf ranges are powers of 2")
    lz = np.array([int(v).bit_length() - 1 for v in d])
    check(bool((lz % 3 == 0).all()), "leaf ranges are powers of 8")
    check(int(tree.counts[:nn].sum()) == n, "leaf counts sum to n")


def uniform_setup(dev):
    """1M uniform particles (seed 42), the drift field and h = 0.012."""
    import torch

    rng = np.random.RandomState(SEED)
    pos = rng.uniform(0.0, 1.0, size=(N, 3)).astype(np.float32)
    spacing = (1.0 / N) ** (1.0 / 3.0)
    drift = torch.from_numpy(rng.uniform(-0.2, 0.2, size=(N, 3)).astype(np.float32) * spacing).to(dev)
    xyz = tuple(torch.from_numpy(np.ascontiguousarray(pos[:, i])).to(dev) for i in range(3))
    h = torch.full((N,), H, dtype=torch.float32, device=dev)
    return xyz, drift, h


def drifted(xyz, drift, sgn):
    return tuple((c + sgn * drift[:, i]) % 1.0 for i, c in enumerate(xyz))


def tree_capacity(n):
    return max(4096, int(3.2 * n / BUCKET) // 1024 * 1024 + 4096)


def main_path_phase(dev, card):
    """Phase 4: the port's cell-list timestep at full size through its public API."""
    import torch

    from cstone_tpu_torch.domain import Domain, sync_with_retry
    from cstone_tpu_torch.models import SphState, sph_density_step
    from cstone_tpu_torch.ops import stencil
    from cstone_tpu_torch.sfc import PERIODIC, make_box
    from cstone_tpu_torch.traversal import cell_list_neighbor_counts, choose_cell_level

    (x, y, z), drift, h = uniform_setup(dev)
    box = make_box(0.0, 1.0, boundaries=PERIODIC, device=dev)
    level = choose_cell_level(box, H)
    check(level == LEVEL, f"cell level {level} != {LEVEL}")

    def step(domain, state, x, y, z):
        state, res = domain.sync(state, x, y, z, h)
        counts, cell_ovf = cell_list_neighbor_counts(
            res.keys, res.x, res.y, res.z, res.h, state.box, LEVEL, CAP,
            n_valid=res.end_index, const_h=True)
        res = dataclasses.replace(res, overflow=torch.maximum(res.overflow, cell_ovf.long()))
        return state, counts, res

    def warm(caps):
        domain = Domain(bucket_size=BUCKET, tree_capacity=caps["tree"], device=dev)
        state = domain.init_state(box=box, boundaries=(1, 1, 1))
        state, counts, res = step(domain, state, x, y, z)
        return domain, state, counts, res

    reset_all_launches()
    t0 = time.perf_counter()
    (domain, state, counts, res), caps = sync_with_retry(warm, {"tree": tree_capacity(N)})
    torch.cuda.synchronize()
    print(f"warm step (cold tree build): {1e3 * (time.perf_counter() - t0):.3f} ms, "
          f"tree capacity {caps['tree']}, leaves {int(state.global_tree.n_nodes)} [{card}]", flush=True)

    step_ms = []
    sgn = 1.0
    for _ in range(DRIFT_STEPS):
        x, y, z = drifted((x, y, z), drift, sgn)
        (state, counts, res), ms = timed_ms(lambda: step(domain, state, x, y, z))
        step_ms.append(ms)
        check(int(res.overflow) == 0, f"overflow {res.overflow_detail.tolist()}")
        sgn = -sgn
    n_owned = int(res.end_index) - int(res.start_index)
    check(n_owned == N, f"owned {n_owned} != {N}")
    mean_nb = float(counts[:N].double().mean())
    expect_nb = N * 4.0 / 3.0 * math.pi * (2 * H) ** 3
    print(f"count steps: {DRIFT_STEPS} x sync+counts, ms/step "
          f"{json.dumps([round(t, 3) for t in step_ms])}, median {np.median(step_ms):.3f} ms, "
          f"{N / (np.median(step_ms) * 1e-3):.4g} particles/s [{card}]", flush=True)
    print(f"mean neighbours {mean_nb:.3f} (expected n*4/3*pi*(2h)^3 = {expect_nb:.3f})", flush=True)
    check(abs(mean_nb - 57.9) <= 0.5, f"mean neighbour count {mean_nb} outside 57.9 +- 0.5")
    cornerstone_ok(state.global_tree, N)

    # SPH density cell path, continuing the same domain state
    m = torch.full((N,), 1.0 / N, dtype=torch.float32, device=dev)
    sph = SphState(domain=state, x=res.x, y=res.y, z=res.z, h=res.h, m=m,
                   n_local=torch.tensor(N, device=dev))
    sph_ms = []
    for _ in range(SPH_STEPS):
        sph = dataclasses.replace(sph, **{c: (getattr(sph, c) + sgn * drift[:, i]) % 1.0
                                         for i, c in enumerate("xyz")})
        (sph, rho, sres), ms = timed_ms(
            lambda: sph_density_step(domain, sph, cell_level=LEVEL, cell_cap=CAP))
        sph_ms.append(ms)
        check(int(sres.overflow) == 0, f"SPH overflow {sres.overflow_detail.tolist()}")
        sgn = -sgn
    launches = all_launches()  # read right after the main path
    mean_rho = float(rho[int(sres.start_index):int(sres.end_index)].double().mean())
    expect_rho = 1.0 + 1.0 / (math.pi * H ** 3 * N)
    print(f"SPH steps: {SPH_STEPS} x sync+density, ms/step "
          f"{json.dumps([round(t, 3) for t in sph_ms])}, median {np.median(sph_ms):.3f} ms, "
          f"{N / (np.median(sph_ms) * 1e-3):.4g} particles/s [{card}]", flush=True)
    print(f"mean density {mean_rho:.5f} (expected 1 + 1/(pi h^3 n) = {expect_rho:.5f})", flush=True)
    check(abs(mean_rho / expect_rho - 1.0) <= 0.02, "mean density outside 2% of 1 + 1/(pi h^3 n)")
    check(bool(torch.isfinite(rho[:N]).all()), "density has non-finite values")
    cornerstone_ok(sph.domain.global_tree, N)
    print(f"phase 4 launches: {json.dumps(launches)}", flush=True)
    for k in ("stencil_counts", "stencil_density"):
        check(launches[k] > 0, f"{k} was not launched on its main path: {launches}")

    # kernels vs plain versions on the main path's own last inputs
    planes = ell_inputs(sres.keys, sres.x, sres.y, sres.z, sres.h, sph.domain.box, LEVEL, CAP,
                        mass=sres.properties[0], n_valid=sres.n_with_halos)
    err = Errors()
    compare_stencil(err, planes, sph.domain.box, LEVEL, "phase-4 inputs", asym=True)
    px, py, pz, ph, r2, pm, valid = planes
    flags = (True, True, True)
    L = sph.domain.box.lengths
    counts_args = (px, py, pz, r2, valid, L, flags, LEVEL)
    density_args = (px, py, pz, ph, valid, L, flags, LEVEL, pm)
    shape = f"level {LEVEL}, cap {CAP}, {N} particles (phase-4 inputs)"
    ends = density_ends(px, py, pz, ph, valid, L, flags, LEVEL)
    bounds = {"stencil_counts": stencil_bound(valid, flags, LEVEL),
              "stencil_density": stencil_bound(valid, flags, LEVEL, ends, pm is not None)}
    print(f"density pass: {ends[0]} ends with q < 2, {ends[1]} with q < 1", flush=True)
    bounds["stencil_counts_asym"] = bounds["stencil_counts"]  # the same function as B1

    # the half-stencil kernel against the one-sided kernel (csrc/stencil.cu
    # with the self mask on) on the same inputs, in turns: old, new, new, old
    one_sided = {
        "stencil_counts": lambda: stencil._launch(False, (px, py, pz, r2, valid),
                                                  (px, py, pz, None, valid), L, flags, LEVEL, True),
        "stencil_density": lambda: stencil._launch(True, (px, py, pz, ph, valid),
                                                   (px, py, pz, pm, valid), L, flags, LEVEL, True),
    }
    check(torch.equal(one_sided["stencil_counts"](), stencil.stencil_counts(*counts_args)),
          "the half-stencil and one-sided kernels disagree on the phase-4 counts")
    times = {}
    for name, args in (("stencil_counts", counts_args), ("stencil_density", density_args)):
        new = lambda: getattr(stencil, name)(*args)
        turns = [cuda_time_ms(fn, 20) for fn in (one_sided[name], new, new, one_sided[name])]
        old_ms, ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
        plain = cuda_time_ms(lambda: getattr(stencil, name + "_plain")(*args), 3)
        b_ms, b_by = bounds[name]
        times[name] = (ms, plain)
        print(f"{name} at {shape}: half-stencil kernel {turns[1]:.4f} / {turns[2]:.4f} ms, "
              f"one-sided kernel {turns[0]:.4f} / {turns[3]:.4f} ms (turns old, new, new, old), "
              f"speed-up {old_ms / ms:.3f}x; bound {b_ms:.4f} ms ({b_by}), share of bound: "
              f"half-stencil {b_ms / ms:.4f}, one-sided {b_ms / old_ms:.4f}; plain {plain:.4f} ms "
              f"[{card}]", flush=True)
    ms = cuda_time_ms(lambda: stencil.stencil_counts_asym(*counts_args), 20)
    plain = cuda_time_ms(lambda: stencil.stencil_counts_asym_plain(*counts_args), 3)
    times["stencil_counts_asym"] = (ms, plain)
    print(f"stencil_counts_asym at {shape}: kernel {ms:.4f} ms, plain {plain:.4f} ms [{card}]",
          flush=True)
    launches = {k: launches[k] for k in ("stencil_counts", "stencil_density")}
    return launches, err, {k: {"ms": ms, "plain_ms": p, "shape": shape, "bound_ms": bounds[k][0],
                               "bound_by": bounds[k][1]} for k, (ms, p) in times.items()}


# ----------------------------------------------------------------------------
# phase 5: path A, tiered adaptive-h cell list
# ----------------------------------------------------------------------------

def two_legs(tgt, cand, lengths, periodic, level, op="count", mass_t=None, mass_c=None):
    """stencil_cross by the route the symmetric kernel replaced: the
    one-sided kernel (csrc/stencil.cu) launched from each end."""
    from cstone_tpu_torch.ops import stencil

    density = op == "density"
    ax, ay, az, _, av = tgt
    bx, by, bz, _, bv = cand
    return (stencil._launch(density, tgt, (bx, by, bz, mass_c, bv), lengths, periodic, level, False),
            stencil._launch(density, cand, (ax, ay, az, mass_t, av), lengths, periodic, level, False))


def tiered_phase(dev, card):
    import torch

    from cstone_tpu_torch.domain import Domain, sync_with_retry
    from cstone_tpu_torch.ops import stencil
    from cstone_tpu_torch.ops.cuda_lib import record_launches
    from cstone_tpu_torch.sfc import PERIODIC, make_box
    from cstone_tpu_torch.traversal import (
        cell_list_neighbor_counts,
        cell_list_neighbor_counts_tiered,
        choose_tier_levels,
        tier_caps,
    )
    from cstone_tpu_torch.utils.workloads import adaptive_h, gaussian_coords

    t0 = time.perf_counter()
    pos = gaussian_coords(N, (0.0, 1.0) * 3, seed=SEED)
    h_np = adaptive_h(pos, (0.0, 1.0) * 3, 100.0)
    levels = choose_tier_levels(h_np, 1.0, max_tiers=3)
    caps, cross = tier_caps(pos, h_np, (0.0, 1.0), levels, slack=1.3)
    # single-level cap at levels[0] from the measured peak occupancy (bench.py:211-219)
    d = 1 << levels[0]
    ijk = np.clip((pos * d).astype(np.int64), 0, d - 1)
    occ_max = int(np.bincount((ijk[:, 0] * d + ijk[:, 1]) * d + ijk[:, 2], minlength=d ** 3).max())
    single_cap = max(64, -(-int(occ_max * 1.1 + 8) // 64) * 64)
    print(f"tiers: levels {levels}, caps {caps}, cross {cross}; single-level cap {single_cap} at "
          f"level {levels[0]}; h min/median/max {h_np.min():.5f}/{np.median(h_np):.5f}/"
          f"{h_np.max():.5f}; host set-up {time.perf_counter() - t0:.3f} s", flush=True)
    check(len(levels) >= 2, f"the Gaussian sample should span at least 2 tiers, got {levels}")

    rng = np.random.RandomState(SEED)
    spacing = (1.0 / N) ** (1.0 / 3.0)
    drift = torch.from_numpy(rng.uniform(-0.2, 0.2, size=(N, 3)).astype(np.float32) * spacing).to(dev)
    xyz = tuple(torch.from_numpy(np.ascontiguousarray(pos[:, i])).to(dev) for i in range(3))
    h = torch.from_numpy(h_np).to(dev)
    box = make_box(0.0, 1.0, boundaries=PERIODIC, device=dev)

    def step(domain, state, x, y, z):
        state, res = domain.sync(state, x, y, z, h)
        counts, ovf = cell_list_neighbor_counts_tiered(
            res.keys, res.x, res.y, res.z, res.h, state.box, levels, caps, cross,
            n_valid=res.end_index)
        res = dataclasses.replace(res, overflow=torch.maximum(res.overflow, ovf.long()))
        return state, counts, res

    def warm(caps_):
        domain = Domain(bucket_size=BUCKET, tree_capacity=caps_["tree"], device=dev)
        state = domain.init_state(box=box, boundaries=(1, 1, 1))
        return (domain,) + step(domain, state, *xyz)

    reset_all_launches()
    t0 = time.perf_counter()
    (domain, state, counts, res), _ = sync_with_retry(warm, {"tree": tree_capacity(N)})
    torch.cuda.synchronize()
    print(f"warm step (cold tree build): {1e3 * (time.perf_counter() - t0):.3f} ms [{card}]", flush=True)
    step_ms, cross_per_step, sgn = [], [], 1.0
    for _ in range(TIERED_STEPS):
        xyz = drifted(xyz, drift, sgn)
        before = all_launches()["stencil_cross"]
        with record_launches() as calls:  # the last step's launches are kept
            (state, counts, res), ms = timed_ms(lambda: step(domain, state, *xyz))
        step_ms.append(ms)
        cross_per_step.append(all_launches()["stencil_cross"] - before)
        check(int(res.overflow) == 0, f"tiered overflow {res.overflow_detail.tolist()}")
        sgn = -sgn
    torch.cuda.synchronize()
    launches = all_launches()  # read right after path A
    print(f"phase 5 launches (path A): {json.dumps(launches)}", flush=True)
    for k in ("stencil_counts", "stencil_cross"):
        check(launches[k] > 0, f"{k} was not launched on path A: {launches}")
    print(f"stencil_cross launches in each drift step: {cross_per_step} ({len(cross)} tier pairs)",
          flush=True)
    check(cross_per_step == [len(cross)] * TIERED_STEPS, "B3 should launch once per tier pair and step")
    n_owned = int(res.end_index)
    check(n_owned == N, f"owned {n_owned} != {N}")
    mean_nb = float(counts[:N].double().mean())
    med = float(np.median(step_ms))
    print(f"tiered steps: {TIERED_STEPS} x sync+tiered counts, ms/step "
          f"{json.dumps([round(t, 3) for t in step_ms])}, median {med:.3f} ms, "
          f"{N / (med * 1e-3):.4g} particles/s, mean neighbours {mean_nb:.3f} [{card}]", flush=True)
    check(mean_nb > 0 and bool((counts[:N] >= 0).all()), "tiered counts must be non-negative")

    # every B1 and B3 launch of the last step against its plain version on
    # the arguments it was given, timed at those shapes; B3 also in turns
    # against the two one-sided launches of csrc/stencil.cu it replaced
    err = Errors()
    cross_ms = cross_old_ms = cross_plain_ms = cross_flops = cross_bytes = 0.0
    names = sorted(name for name, _, _ in calls)
    check(names == ["stencil_counts"] * len(levels) + ["stencil_cross"] * len(cross),
          f"path A launched {names}")
    for name, args, got in calls:
        want, plain_ms = timed_ms(lambda: plain_of(name)(*args))
        new = lambda: getattr(stencil, name)(*args)
        if name == "stencil_cross":
            tgt, cand, level = args[0], args[1], args[4]
            lanes = "B" if stencil.cross_lanes_on_b(tgt[4], cand[4]) else "A"
            shape = (f"cross pass, level {level}, caps {tgt[0].shape[1]}/{cand[0].shape[1]}, "
                     f"lanes on {lanes}")
            for g, w in zip(got, want):
                err.counts(name, g, w, shape)
            old = lambda: two_legs(*args)
            check(all(torch.equal(g, w) for g, w in zip(old(), want)), "the two-leg route disagrees")
            turns = [device_time_ms(fn, 5) for fn in (old, new, new, old)]
            ms, old_ms = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
            pairs = stencil_pairs(tgt[4], cand[4], args[3], level, same=False)
            shape += (f", {pairs:.6g} pairs; two one-sided legs {turns[0]:.4f} / {turns[3]:.4f} "
                      f"ms, symmetric {turns[1]:.4f} / {turns[2]:.4f} ms (turns old, new, new, "
                      f"old), {ms * 1e9 / max(pairs, 1.0):.4g} ps per pair")
            cross_ms, cross_old_ms = cross_ms + ms, cross_old_ms + old_ms
            cross_plain_ms += plain_ms
            # both tables read once, both results written once; one d2 and
            # a compare at each end per cross pair
            cross_bytes += sum(stencil_bytes(t[4], 4) for t in (tgt, cand))
            cross_flops += (OPS_D2 + 2 * OPS_CMP) * pairs
        else:
            ms = device_time_ms(new, 5)
            valid, flags, level = args[4], args[6], args[7]
            b_ms, b_by = stencil_bound(valid, flags, level)
            shape = (f"same tier, level {level}, cap {args[0].shape[1]}, bound {b_ms:.4f} ms "
                     f"({b_by})")
            err.counts(name, got, want, shape)
        print(f"{name} on path A, {shape}: bit-equal to plain; kernel {ms:.4f} ms (device time), "
              f"plain {plain_ms:.4f} ms (one call) [{card}]", flush=True)

    # the single-level passes at levels[0] on the same sync, through the
    # user entry point: the kernel route (B1), then the one-sided route
    # (B4) with its launches counted around that pass alone
    single = {}
    for impl in ("pallas", "pallas_asym"):
        reset_all_launches()
        with record_launches() as calls:
            (c, ovf), ms = timed_ms(lambda: cell_list_neighbor_counts(
                res.keys, res.x, res.y, res.z, res.h, state.box, levels[0], single_cap,
                n_valid=res.end_index, impl=impl))
        torch.cuda.synchronize()
        single[impl] = (c, ms, all_launches(), calls)
        check(not bool(ovf), f"single-level cap {single_cap} overflowed")
    asym_launches = single["pallas_asym"][2]
    print(f"launches of the impl=\"pallas_asym\" pass: {json.dumps(asym_launches)}", flush=True)
    check(asym_launches["stencil_counts_asym"] > 0, "impl=\"pallas_asym\" did not launch B4")
    for impl, (c, ms, _, _) in single.items():
        ndiff = int((c[:N] != counts[:N]).sum())
        print(f"single-level pass impl={impl} at level {levels[0]}, cap {single_cap}: {ms:.3f} ms, "
              f"{ndiff} particles differ from the tiered counts [{card}]", flush=True)
        check(ndiff == 0, f"tiered counts are not bit-equal to the single-level impl={impl} pass")
    [(name, args, got)] = single["pallas_asym"][3]
    want, plain_ms = timed_ms(lambda: plain_of(name)(*args))
    err.counts(name, got, want, "single-level pass of path A")
    print(f"{name} at level {levels[0]}, cap {single_cap}, {N} Gaussian particles: bit-equal to "
          f"plain; plain {plain_ms:.4f} ms (one call) [{card}]", flush=True)

    shape = (f"the {len(cross)} cross passes of one path-A step (pairs {sorted(cross)}, levels "
             f"{levels}), {N} Gaussian particles; times summed over the passes")
    b_ms, b_by = bound(cross_flops, cross_bytes)
    print(f"stencil_cross, {shape}: symmetric kernel {cross_ms:.4f} ms, two one-sided legs "
          f"{cross_old_ms:.4f} ms (speed-up {cross_old_ms / cross_ms:.3f}x), bound {b_ms:.4f} ms "
          f"({b_by}), share of bound {b_ms / cross_ms:.4f} (two legs {b_ms / cross_old_ms:.4f}) "
          f"[{card}]", flush=True)
    return ({"stencil_cross": launches["stencil_cross"],
             "stencil_counts_asym": asym_launches["stencil_counts_asym"]}, err,
            {"stencil_cross": {"ms": cross_ms, "plain_ms": cross_plain_ms, "shape": shape,
                               "bound_ms": b_ms, "bound_by": b_by}})


# ----------------------------------------------------------------------------
# phase 6: path B, octree find_neighbors
# ----------------------------------------------------------------------------

def find_neighbors_phase(dev, card):
    import torch

    from cstone_tpu_torch.domain import Domain, sync_with_retry
    from cstone_tpu_torch.ops import neighbors_v1, neighbors_v2
    from cstone_tpu_torch.ops.cuda_lib import record_launches
    from cstone_tpu_torch.sfc import PERIODIC, make_box
    from cstone_tpu_torch.traversal import cell_list_neighbor_counts, find_neighbors

    xyz, drift, h = uniform_setup(dev)
    box = make_box(0.0, 1.0, boundaries=PERIODIC, device=dev)
    def step(domain, state, x, y, z):
        state, res = domain.sync(state, x, y, z, h)
        view = domain.ns_view(res, state.box)
        counts, _ = find_neighbors(res.x, res.y, res.z, res.h, view, state.box, use_pallas="v2",
                                   n_targets=N, **NB_KW)
        return state, res, view, counts

    def warm(caps):
        domain = Domain(bucket_size=BUCKET, tree_capacity=caps["tree"], device=dev)
        state = domain.init_state(box=box, boundaries=(1, 1, 1))
        state, res = domain.sync(state, *xyz, h)
        return domain, state, res

    reset_all_launches()
    t0 = time.perf_counter()
    (domain, state, res), _ = sync_with_retry(warm, {"tree": tree_capacity(N)})
    view = domain.ns_view(res, state.box)
    counts, _ = find_neighbors(res.x, res.y, res.z, res.h, view, state.box, use_pallas="v2",
                               n_targets=N, **NB_KW)
    torch.cuda.synchronize()
    print(f"warm step (cold tree build + ns_view + find_neighbors v2): "
          f"{1e3 * (time.perf_counter() - t0):.3f} ms [{card}]", flush=True)
    step_ms, sgn = [], 1.0
    for _ in range(FIND_STEPS):
        xyz = drifted(xyz, drift, sgn)
        with record_launches() as calls_v2:  # the last step's launch is kept
            (state, res, view, counts), ms = timed_ms(lambda: step(domain, state, *xyz))
        step_ms.append(ms)
        check(int(res.overflow) == 0, f"sync overflow {res.overflow_detail.tolist()}")
        sgn = -sgn
    with record_launches() as calls_v1:
        v1, _ = find_neighbors(res.x, res.y, res.z, res.h, view, state.box, use_pallas="v1",
                               n_targets=N, **NB_KW)
    torch.cuda.synchronize()
    launches = all_launches()
    print(f"phase 6 launches: {json.dumps(launches)}", flush=True)
    for k in ("pairwise_count_runs", "pairwise_count"):
        check(launches[k] > 0, f"{k} was not launched on path B: {launches}")
    print(f"find_neighbors settings: {json.dumps(NB_KW)}", flush=True)

    cell, ovf = cell_list_neighbor_counts(res.keys, res.x, res.y, res.z, res.h, state.box, LEVEL, CAP,
                                          n_valid=res.end_index)
    check(not bool(ovf), "cell-list cap overflowed")
    v2c, v1c, cc = (c[:N].long() for c in (counts, v1, cell))
    mean_nb = float(v2c.double().mean())
    med = float(np.median(step_ms))
    print(f"find_neighbors steps: {FIND_STEPS} x sync+ns_view+find_neighbors(v2), ms/step "
          f"{json.dumps([round(t, 3) for t in step_ms])}, median {med:.3f} ms, "
          f"{N / (med * 1e-3):.4g} particles/s, mean neighbours {mean_nb:.3f} [{card}]", flush=True)
    check(abs(mean_nb - 57.9) <= 0.5, f"find_neighbors mean count {mean_nb} outside 57.9 +- 0.5")
    for name, other in (("v1", v1c), ("cell list", cc)):
        diff = (v2c - other).abs()
        nd = int((diff > 0).sum())
        print(f"v2 vs {name}: {nd} particles differ, max |diff| {int(diff.max())}", flush=True)
        check(nd <= 10 and int(diff.max()) <= 1, f"v2 and {name} counts disagree beyond flips")
    diff = (v1c - cc).abs()
    print(f"v1 vs cell list: {int((diff > 0).sum())} particles differ, max |diff| {int(diff.max())}",
          flush=True)
    check(int((diff > 0).sum()) <= 10 and int(diff.max()) <= 1, "v1 and cell-list counts disagree")

    # the last B5 and B6 launches against their plain versions on the
    # arguments they were given, timed at those shapes
    err = Errors()
    times = {}
    for want_name, mod, calls in (("pairwise_count_runs", neighbors_v2, calls_v2),
                                  ("pairwise_count", neighbors_v1, calls_v1)):
        [(name, args, got)] = calls
        check(name == want_name, f"{want_name} expected, {name} launched")
        want, plain_ms = timed_ms(lambda: plain_of(name)(*args))
        err.counts(name, got, want, "phase-6 inputs")
        b_ms, b_by = pairwise_bound(name, args)
        shape = f"{N} particles, {args[0].shape[0]} groups of {args[0].shape[1]}"
        times[name] = {"ms": cuda_time_ms(lambda: getattr(mod, name)(*args), 10),
                       "plain_ms": plain_ms, "shape": shape + " (phase-6 inputs; plain: one call)",
                       "bound_ms": b_ms, "bound_by": b_by}
        print(f"{name} at {times[name]['shape']}: kernel {times[name]['ms']:.4f} ms, "
              f"plain {times[name]['plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}), share of bound "
              f"{b_ms / times[name]['ms']:.4f} [{card}]", flush=True)
    return {k: launches[k] for k in ("pairwise_count_runs", "pairwise_count")}, err, times


def pairwise_bound(name, args):
    """Bound of B5 (pairwise_count_runs) or B6 (pairwise_count) on the
    arguments a path launched it with: every target with r2 >= 0 against
    its group's candidates, d2 and a compare per test, each input read
    once, one count written per target."""
    targets, r2 = args[0], args[1]
    live = (r2 >= 0).sum(dim=1).double()
    head = targets.numel() * 4 + r2.numel() * 4 + r2.numel() * 4  # targets, r2, the counts
    if name == "pairwise_count_runs":
        run_start, run_len, xs = args[2], args[3], args[4]
        pairs = float((live * run_len.sum(dim=1).double()).sum())
        nbytes = head + run_start.numel() * run_start.element_size() * 2 + 3 * xs.numel() * 4
        return bound(pairs * (OPS_D2 + OPS_CMP), nbytes)
    cand, cidx = args[2], args[3]
    pairs = float((live * (cidx >= 0).sum(dim=1).double()).sum())
    nbytes = head + cand.numel() * 4 + cidx.numel() * cidx.element_size()
    return bound(pairs * (OPS_D2 + OPS_CMP), nbytes)


def build_all():
    """Build the four kernel libraries in parallel, one nvcc each."""
    from cstone_tpu_torch.ops import neighbors_v1, neighbors_v2, stencil

    libs = (stencil.SYM_LIBRARY, stencil.LIBRARY, neighbors_v2.LIBRARY, neighbors_v1.LIBRARY)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda lib: lib.load(), libs))
    print(f"{len(libs)} kernel libraries built and loaded in {time.perf_counter() - t0:.3f} s",
          flush=True)
    for lib in libs:  # ptxas -v: registers, shared memory, spills per kernel
        for line in lib.build_log.splitlines():
            if any(k in line for k in ("registers", "spill", "Compiling entry")) or "error" in line.lower():
                print(f"  {lib.source.name}: " + line.strip(), flush=True)


def main():
    import torch

    phase("1 card")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this check needs a GPU")
    card = card_line()
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}", flush=True)
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    phase("2 build")
    build_all()

    phase("3 kernel vs plain")
    err = Errors()
    kernel_vs_plain_phase(dev, err)

    phase("4 main path: sync + cell-list counts and SPH density")
    launches, err4, timing = main_path_phase(dev, card)

    phase("5 path A: sync + tiered adaptive-h counts")
    launches5, err5, times5 = tiered_phase(dev, card)
    launches.update(launches5)
    timing.update(times5)

    phase("6 path B: sync + ns_view + find_neighbors")
    launches6, err6, times6 = find_neighbors_phase(dev, card)
    launches.update(launches6)
    timing.update(times6)

    for e in (err4, err5, err6):
        for k, v in e.max.items():
            err.max[k] = max(err.max[k], v)
    print(f"total time {time.perf_counter() - t_start:.3f} s [{card}]", flush=True)
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep, "launches": launches[name],
         "max_abs_err": err.max[name], "library_ms": None, **timing[name]}
        for name, (src, rep) in KERNELS.items()
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
