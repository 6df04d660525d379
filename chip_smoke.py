#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (cstone_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure raises and exits non-zero:
  1. card: nvidia-smi name and power limit, torch's device name; refuses
     to run without CUDA (there is no CPU fallback);
  2. build: compiles the three kernel sources (csrc/stencil.cu,
     neighbors_v2.cu, neighbors_v1.cu) with nvcc, one process each, all
     started together;
  3. kernel vs plain version on the card: B1/B2 at levels 3 and 5, cap 64,
     periodic and open, uniform and Gaussian; B1/B2 at level 2 with caps
     1088 and 2496 (densest cell above 1024); B3 both legs at levels 2 and
     3 with unequal caps, periodic and open, count and density; B4 against
     impl="xla"; B5 and B6 on the arguments find_neighbors launched them
     with after Domain.sync of 16K uniform and Gaussian particles with the
     test_neighbors.py group settings. Counts bit-equal, density within
     rtol 1e-5;
  4. main path of the cell list at full size: 1M uniform particles in the
     periodic unit box, h = 0.012, bucket 64, cell level 5, ELL cap 64.
     Domain.sync + cell_list_neighbor_counts for 1 warm and 10 drift
     steps, then 3 steps of the SPH density cell path. Checks overflow,
     mean neighbour count 57.9 +- 0.5, mean density within 2% of
     1 + 1/(pi h^3 n), the cornerstone invariants, and that B1/B2
     launched; times the kernels against their plain versions;
  5. path A, the tiered adaptive-h cell list: 1M Gaussian particles (seed
     42) in the periodic unit box, h = adaptive_h(pos, 100 neighbours),
     bucket 64, tiers from choose_tier_levels(max_tiers=3) and tier_caps
     (slack 1.3). Domain.sync + cell_list_neighbor_counts_tiered for 1
     warm and 3 drift steps; checks overflow 0, at least 2 tiers, B1 and
     B3 launched, every B1 and B3 launch of the last step bit-equal to its
     plain version on the arguments it was given, and the tiered counts
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
just after. Kernel-vs-plain checks of phases 3, 5 and 6 take the
arguments and results of the path's own launches (record_launches). The
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
KERNELS = {  # name: (source, TPU kernel it replaces)
    "stencil_counts": (STENCIL_SRC, "cstone_tpu/ops/pallas_stencil.py:295"),
    "stencil_density": (STENCIL_SRC, "cstone_tpu/ops/pallas_stencil.py:295"),
    "stencil_cross": (STENCIL_SRC, "cstone_tpu/ops/pallas_stencil.py:589"),
    "stencil_counts_asym": (STENCIL_SRC, "cstone_tpu/ops/pallas_stencil.py:149"),
    "pairwise_count_runs": ("cstone_tpu_torch/csrc/neighbors_v2.cu",
                            "cstone_tpu/ops/pallas_neighbors_v2.py:103"),
    "pairwise_count": ("cstone_tpu_torch/csrc/neighbors_v1.cu",
                       "cstone_tpu/ops/pallas_neighbors.py:31"),
}


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
    """B1 (and B4) counts and B2 density, kernel vs plain."""
    from cstone_tpu_torch.ops import stencil

    px, py, pz, ph, r2, pm, valid = planes
    flags, L = flags_of(box), box.lengths
    want = stencil.stencil_counts_plain(px, py, pz, r2, valid, L, flags, level)
    err.counts("stencil_counts", stencil.stencil_counts(px, py, pz, r2, valid, L, flags, level),
               want, what)
    if asym:  # B4 against impl="xla", the plain roll stencil
        err.counts("stencil_counts_asym",
                   stencil.stencil_counts_asym(px, py, pz, r2, valid, L, flags, level), want, what)
    for mass in (None, pm):
        err.density("stencil_density",
                    stencil.stencil_density(px, py, pz, ph, valid, L, flags, level, mass),
                    stencil.stencil_density_plain(px, py, pz, ph, valid, L, flags, level, mass),
                    what)


def cross_tables(dev, level, periodic, op, n, seed=3):
    """Two disjoint sets of one Gaussian sample packed at `level` with
    unequal caps (A: 70%, cap + 64; B: 30%): [((x, y, z, w, valid), mass)]
    with w = r2 (count) or h (density)."""
    import torch

    from cstone_tpu_torch.ops.keys64 import srl

    keys, cols, box = sorted_sample(dev, n, periodic, True, seed, level)
    in_b = torch.from_numpy(np.random.RandomState(seed).uniform(size=keys.shape[0]) < 0.3).to(dev)
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

    from cstone_tpu_torch.ops import stencil
    from cstone_tpu_torch.ops.cuda_lib import record_launches
    from cstone_tpu_torch.traversal import neighbors

    for level, n in ((3, 2500), (5, 150_000)):  # fullest cell stays below cap 64
        for periodic in (True, False):
            for gauss in (False, True):
                keys, cols, box = sorted_sample(dev, n, periodic, gauss, 7, level)
                planes = ell_inputs(keys, *cols[:4], box, level, CAP, mass=cols[4])
                what = f"level {level} n {n} periodic {periodic} gauss {gauss}"
                compare_stencil(err, planes, box, level, what, asym=True)
                print(f"B1/B2/B4 vs plain: {what}: ok", flush=True)

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

    # B3: both legs, unequal caps
    for level, n in ((2, 20_000), (3, 50_000)):
        for periodic in (True, False):
            for op in ("count", "density"):
                ((ta, ma), (tb, mb)), box = cross_tables(dev, level, periodic, op, n)
                flags = flags_of(box)
                mass = dict(mass_t=ma, mass_c=mb) if op == "density" else {}
                got = stencil.stencil_cross(ta, tb, box.lengths, flags, level, op=op, **mass)
                want = stencil.stencil_cross_plain(ta, tb, box.lengths, flags, level, op=op, **mass)
                what = (f"level {level} n {n} caps {ta[0].shape[1]}/{tb[0].shape[1]} "
                        f"periodic {periodic} {op}")
                for g, w in zip(got, want):
                    (err.counts if op == "count" else err.density)("stencil_cross", g, w, what)
                print(f"B3 vs plain, both legs: {what}: ok", flush=True)

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
    times = {
        name: (cuda_time_ms(lambda: getattr(stencil, name)(*args), 20),
               cuda_time_ms(lambda: getattr(stencil, name + "_plain")(*args), 3))
        for name, args in (("stencil_counts", counts_args), ("stencil_density", density_args),
                           ("stencil_counts_asym", counts_args))
    }
    shape = f"level {LEVEL}, cap {CAP}, {N} particles (phase-4 inputs)"
    for k, (ms, plain) in times.items():
        print(f"{k} at {shape}: kernel {ms:.4f} ms, plain {plain:.4f} ms [{card}]", flush=True)
    launches = {k: launches[k] for k in ("stencil_counts", "stencil_density")}
    return launches, err, {k: {"ms": ms, "plain_ms": p, "shape": shape} for k, (ms, p) in times.items()}


# ----------------------------------------------------------------------------
# phase 5: path A, tiered adaptive-h cell list
# ----------------------------------------------------------------------------

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
    step_ms, sgn = [], 1.0
    for _ in range(TIERED_STEPS):
        xyz = drifted(xyz, drift, sgn)
        with record_launches() as calls:  # the last step's launches are kept
            (state, counts, res), ms = timed_ms(lambda: step(domain, state, *xyz))
        step_ms.append(ms)
        check(int(res.overflow) == 0, f"tiered overflow {res.overflow_detail.tolist()}")
        sgn = -sgn
    torch.cuda.synchronize()
    launches = all_launches()  # read right after path A
    print(f"phase 5 launches (path A): {json.dumps(launches)}", flush=True)
    for k in ("stencil_counts", "stencil_cross"):
        check(launches[k] > 0, f"{k} was not launched on path A: {launches}")
    n_owned = int(res.end_index)
    check(n_owned == N, f"owned {n_owned} != {N}")
    mean_nb = float(counts[:N].double().mean())
    med = float(np.median(step_ms))
    print(f"tiered steps: {TIERED_STEPS} x sync+tiered counts, ms/step "
          f"{json.dumps([round(t, 3) for t in step_ms])}, median {med:.3f} ms, "
          f"{N / (med * 1e-3):.4g} particles/s, mean neighbours {mean_nb:.3f} [{card}]", flush=True)
    check(mean_nb > 0 and bool((counts[:N] >= 0).all()), "tiered counts must be non-negative")

    # every B1 and B3 launch of the last step against its plain version on
    # the arguments it was given, timed at those shapes
    err = Errors()
    cross_ms = cross_plain_ms = 0.0
    names = sorted(name for name, _, _ in calls)
    check(names == ["stencil_counts"] * len(levels) + ["stencil_cross"] * len(cross),
          f"path A launched {names}")
    for name, args, got in calls:
        want, plain_ms = timed_ms(lambda: plain_of(name)(*args))
        ms = cuda_time_ms(lambda: getattr(stencil, name)(*args), 5)
        if name == "stencil_cross":
            tgt, cand, level = args[0], args[1], args[4]
            shape = f"cross pass, both legs, level {level}, caps {tgt[0].shape[1]}/{cand[0].shape[1]}"
            for g, w in zip(got, want):
                err.counts(name, g, w, shape)
            cross_ms, cross_plain_ms = cross_ms + ms, cross_plain_ms + plain_ms
        else:
            shape = f"same tier, level {args[7]}, cap {args[0].shape[1]}"
            err.counts(name, got, want, shape)
        print(f"{name} on path A, {shape}: bit-equal to plain; kernel {ms:.4f} ms, "
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
             f"{levels}), {N} Gaussian particles; times summed over the passes, both legs each")
    return ({"stencil_cross": launches["stencil_cross"],
             "stencil_counts_asym": asym_launches["stencil_counts_asym"]}, err,
            {"stencil_cross": {"ms": cross_ms, "plain_ms": cross_plain_ms, "shape": shape}})


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
        times[name] = {"ms": cuda_time_ms(lambda: getattr(mod, name)(*args), 10),
                       "plain_ms": plain_ms,
                       "shape": f"{N} particles, {args[0].shape[0]} groups of {args[0].shape[1]} "
                                f"(phase-6 inputs; plain: one call)"}
        print(f"{name} at {times[name]['shape']}: kernel {times[name]['ms']:.4f} ms, "
              f"plain {times[name]['plain_ms']:.4f} ms [{card}]", flush=True)
    return {k: launches[k] for k in ("pairwise_count_runs", "pairwise_count")}, err, times


def build_all():
    """Build the three kernel libraries in parallel, one nvcc each."""
    from cstone_tpu_torch.ops import neighbors_v1, neighbors_v2, stencil

    libs = (stencil.LIBRARY, neighbors_v2.LIBRARY, neighbors_v1.LIBRARY)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda lib: lib.load(), libs))
    print(f"3 kernel libraries built and loaded in {time.perf_counter() - t0:.3f} s", flush=True)
    for lib in libs:
        for line in lib.build_log.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
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
         "max_abs_err": err.max[name], **timing[name]}
        for name, (src, rep) in KERNELS.items()
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
