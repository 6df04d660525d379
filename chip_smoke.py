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
     arguments they were given;
  7. path C, a Domain whose focus tree is not its global tree: 1M uniform
     particles, h = 0.012, Domain(bucket_size=1024, bucket_size_focus=64,
     focus_capacity != tree_capacity). Cold sync (the focus tree grown
     from the root by focus_converge), 4 drift steps, one step at rest,
     each followed by cell_list_neighbor_counts (B1), the last drift step
     also by ns_view + find_neighbors "v2" on the focus tree (B5); beside
     it a Domain with bucket 64 (phase 4's, the fast_focus branch) on the
     same positions. Checks: overflow and all 7 overflow_detail entries 0,
     focus_converged after each step, the focus tree (leaves, n_leaf,
     leaf_counts) and layout, keys, x/y/z/h and counts bit-equal to the
     bucket-64 Domain's, the global tree the cornerstone tree at bucket
     1024 (every leaf <= 1024, every sibling group's parent > 1024), the
     step at rest converged in one iteration without one
     build_linked_octree call, the B1 and B5 launches of the last drift
     step bit-equal to their plain versions. Prints ms/step of sync alone
     and of sync+counts, cold and warm, for both Domains in turns, the
     converge iterations of each step, and the torch operations and host
     read-backs one cold and one warm sync dispatch;
  8. path D, one rank's locally essential tree and its halos from the
     pool: the sorted keys and global tree of phase 7, an 8-rank SFC
     assignment, then for rank 3 focus_converge from the root with MAC
     marking (theta 0.5) and all rank boundaries mandatory, per-leaf radii
     2 x max h, find_halos. Checks: converged, overflow 0, a cornerstone
     array whose counts sum to n, every boundary a leaf key, leaves inside
     the rank's range equal to path C's focus tree there and no more
     outside (both counts printed), halo flags 0 inside and equal to an all-pairs box
     overlap on the card, mark_macs on the card equal to the same function
     on CPU copies of its inputs, every marked node's parent marked, no
     marked node wholly inside the focus. Prints the converge iterations,
     batched_mark's levels per call and the ms of the whole build;
  9. path E, 8 ranks of the pool protocol on the one card: phase 4's 1M
     positions, rank r starting from the strided slice r::8, local
     capacity 262,144, Domain(exchange_mode="pool", comm=...) with
     buckets 64/64 and theta 0.5, the ranks run as threads of this
     process by parallel.run_ranks. A cold step, each rank running
     sync_with_retry inside run_ranks on the largest overflow of any
     rank, then 3 drift steps (phase 4's drift),
     each fed by compact_owned; after each sync, B1 and B2 on every rank's
     buffer (n_valid = n_with_halos). Checks against phase 4's run of the
     same steps: every rank's global tree bit-equal, counts included; the
     owned ranges a partition of the 1M particles, each owned key inside
     its rank's range; B1 counts by particle id (reapply_sync of an id
     field) bit-equal, B2 densities within rtol 1e-5; exchange_halos of
     the ids puts every halo slot's owner id there; rank 3's halo flags
     equal all box pairs on the cold step; B1 and B2 launched once per
     rank and step, and every launch of the last step equal to its plain
     version. Prints the 8-rank sync wall time per step, each rank's sync
     time and its share in mark_macs, the largest gap between a path-E
     density and phase 4's (kept apart from the kernels' max_abs_err,
     which is each kernel against its plain version), the pool bytes per
     rank, the device count and the peak memory allocated;
 10. path F, the same 8 ranks, inputs and steps with the Domain's
     default exchange_mode="p2p" (the dense protocols of
     parallel/exchange.py, capacities from Domain._p2p_caps), the same
     checks against phase 4, and every rank's assignment, focus leaves,
     halo flags, layout, n_with_halos and the ids exchange_halos puts
     into its halo slots (p2p reapply_sync fills the owned slots only)
     equal to path E's at the same step. Prints per step the all_to_all rounds and their
     buffer bytes per rank (RankTally), the overflow_detail, and path
     E's sync walls beside path F's;
 11. path G, the ranks as processes: LET_RANKS rank processes on the one
     card (parallel.dist.spawn_ranks over gloo, since nccl refuses two
     ranks on one device; every collective's CUDA operand goes through
     host memory), the kernels phase 2 built loaded, never built, in each.
     Each process runs (a) and then (b). (a) the dry run of
     cstone_tpu_torch.multichip (dryrun_multichip's rank_step): 256
     particles a rank, the dense then the ragged protocol, the neighbour
     sum through B5 equal to brute force, B5 launched once in every rank
     and protocol, each launch equal to its plain version. (b) path F's inputs and steps in the p2p mode, with the dense
     protocol and then with protocol="ragged" at its default totals: the
     checks of path F against phase 4 (global trees, B1 counts by particle,
     B2 within rtol 1e-5, the owned partition, the halo slots' ids), every
     rank's assignment, focus leaves, halo flags, layout, buffer size and
     halo ids equal to path F's (dense) and to the dense run's (ragged),
     B1 and B2 once a rank and step, and every launch of the last step
     equal to its plain version. Prints per step the 8-process sync wall
     and each rank's sync ms beside path F's, each rank's all_to_all and
     ragged rounds and the bytes it sends in them (RankTally) beside path
     F's, the bytes staged through host memory, each process's peak
     memory beside path F's, and the host's core count;
 12. path H, bench.py fn mode's other feeds of B5, on phase 6's last
     sync (the same sorted particles): groups of 256 with bounding boxes
     and radii 2 max h (bench.py:594-612); the grid cover
     (build_cell_table at level 6, group_cover_runs with 8 cells a dim,
     run cap 48) and the depth-first walk (batched_collect_leaves with
     bench.py's criterion, 320 leaves a group, then merge_leaf_runs), each
     feeding one B5 launch. Checks: no run or leaf overflow, the counts by
     particle of both routes bit-equal to phase 6's "v2" counts, B5
     launched twice, each launch equal to its plain version. Prints the ms
     of the table, the cover, the walk, merge_leaf_runs and phase 6's
     breadth-first walk on the same groups, B5's ms on each route's runs,
     the candidate pairs each route makes B5 test, the largest runs a
     group;
 13. path I, the clients. (a) the simulation loop (models/simulation.py):
     phase 4's 1M positions, h = 0.012, velocities normal(0, 0.05) (seed
     42) minus their mean, sim_init, a cold step and 5 sim_steps at dt
     2e-3 with JAX's defaults (ng_max 96 raised to 128, and said so, if
     the cold step overflows); checks overflow 0 at every step, the
     energy drift over steps 1-5 below 2e-2, |momentum| below 1e-4 x
     sum |v|, n_local 1M. Then the same positions on 8 ranks as threads
     (run_ranks, p2p, path F's capacities), a cold step and 2 steps:
     n_local summing to 1M, energy and momentum equal on every rank and
     within 1e-4 of |E| and 1e-6 x sum |v| of the one-rank run at the
     same step. Prints ms a step and the share in find_neighbors, the
     8-rank walls and the largest gaps. (b) gravity: 1M particles
     normal(0, 0.25) clipped to +-0.99 in the open box [-1, 1], masses
     uniform(0.5, 1.5), Domain(theta=0.4, bucket 64).sync(grav=True),
     update_expansion_centers, gravity_monopole on the focus tree with
     leaf_cap 4096 and cand_cap sized from a first call's overflow;
     checks overflow 0, and on 1,024 sampled targets against float64
     direct sums over all 1M sources on the card the median relative
     error below 2e-2 and the 95th percentile below 0.2. Prints the ms of
     the sync, the centres, the call and, apart, its P2P leaf walk,
     monopole walk and P2P sums. Path I launches no kernel.
 14. path J, the dense p2p protocol over a peer window: (a) path F's
     inputs, capacities and steps on LET_RANKS thread ranks with
     Domain(peer_window=W), the cold step grown from W = 1 by
     overflow_detail[6] (each try a sync), then 3 drift steps at the
     converged W. Checks at every try: every rank's halo record holds
     2W+1 rows, and overflow_detail[6] equals the largest rank offset of
     the halo leaves' owners and of diagnostics()' mac_peer_max_offset
     where that exceeds W; at the converged W: path F's checks against
     phase 4 and every rank's assignment, focus leaves, halo flags,
     layout, buffer size and halo ids equal to path F's at the same step,
     B1 and B2 once a rank and step, the last step's launches equal to
     plain. Prints per sync W, win_need, each rank's ppermute and
     all_to_all rounds and bytes beside path F's, the sync wall beside
     path F's, and each rank's ms in find_peers_mac. (b) the converged
     W's cold step on LET_RANKS rank processes over gloo (spawn_ranks),
     equal to (a)'s, B1/B2 once in each, held to plain there.
Each path's launch counts are set to 0 just before it is driven and read
just after (paths E and F each over their 4 steps; path G in each rank
process, summed; path H over its two routes; path J over (a), plus (b)'s
processes). Every kernel's bound is the larger of its FP32 operations over
67 TFLOP/s and its bytes over 3.35 TB/s, counted from that run's inputs;
no single PyTorch call computes any of these functions, so library_ms is
null. Kernel-vs-plain checks of phases 3, 5, 6 and 12 take the
arguments and results of the path's own launches (record_launches).
Kernel times: CUDA events around back-to-back launches (phases 4 and 6);
in phase 5, whose short launches the host could not keep the card busy
with, device time: CUDA events around launches queued behind a spin
kernel (device_time_ms), each same-tier B1 launch also timed every way
scripts/torch_sym_kernels.py times it (tier_timer_readings); plain
times: one call. The
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
FOCUS_STEPS = 4
GLOBAL_BUCKET = 1024  # path C's global tree; its focus tree keeps BUCKET
LET_RANKS, LET_RANK, LET_THETA = 8, 3, 0.5
# path E: LET_RANKS ranks in pool mode, each with this local capacity: 125K
# owned plus about 1,736 halo leaves x 30.5 particles (path D's rank 3)
POOL_LOCAL_CAP = 262_144
POOL_DRIFT_STEPS = 3
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


def tier_timer_readings(fn) -> dict:
    """One launch timed, in ms a call, every way this script and
    scripts/torch_sym_kernels.py time it: device_time_ms with queues of 1,
    5 (this script's), 20 (the script's queued_ms) and 80 calls; CUDA
    events around 20 calls issued to an idle card (the script's ms); the
    script's torch.profiler sums over 20 calls, of every kernel and memset
    of the call and of the stencil kernel alone (0 where the profiler
    records nothing). A cost paid once a queue would show as a reading
    that falls with the queue's length."""
    from scripts.torch_sym_kernels import device_ms

    out = {f"queue_{n}": device_time_ms(fn, n) for n in (1, 5, 20, 80)}
    out["events_20"] = cuda_time_ms(fn, 20)
    out["profiler_all_20"], out["profiler_kernel_20"] = device_ms(fn, 20)
    return out


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


def tree_capacity(n, bucket=BUCKET):
    return max(4096, int(3.2 * n / bucket) // 1024 * 1024 + 4096)


def main_path_phase(dev, card):
    """Phase 4: the port's cell-list timestep at full size through its public API."""
    import torch

    from cstone_tpu_torch.domain import Domain, sync_with_retry
    from cstone_tpu_torch.models import SphState, sph_density_step
    from cstone_tpu_torch.ops import stencil
    from cstone_tpu_torch.sfc import PERIODIC, make_box
    from cstone_tpu_torch.traversal import cell_list_neighbor_counts, cell_list_sph_density, choose_cell_level

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

    m = torch.full((N,), 1.0 / N, dtype=torch.float32, device=dev)

    def keep_reference(state, counts, res):
        """Path E's reference for one step: the global tree, and the counts
        and the density (B2, mass 1/N) by particle id (the index of the
        unsorted input)."""
        rho, ovf = cell_list_sph_density(res.keys, res.x, res.y, res.z, res.h, state.box, LEVEL, CAP,
                                         mass=m, n_valid=res.n_with_halos)
        check(not bool(ovf), "cell-list cap overflowed")
        by_id = lambda v: torch.empty_like(v[:N]).index_copy_(0, res.sort_order[:N], v[:N])  # noqa: E731
        t = state.global_tree
        nn = int(t.n_nodes)
        reference.append({"tree": (t.keys[:nn + 1].clone(), t.counts[:nn].clone()),
                          "counts": by_id(counts), "rho": by_id(rho)})

    reference = []
    reset_all_launches()
    t0 = time.perf_counter()
    (domain, state, counts, res), caps = sync_with_retry(warm, {"tree": tree_capacity(N)})
    torch.cuda.synchronize()
    print(f"warm step (cold tree build): {1e3 * (time.perf_counter() - t0):.3f} ms, "
          f"tree capacity {caps['tree']}, leaves {int(state.global_tree.n_nodes)} [{card}]", flush=True)
    keep_reference(state, counts, res)

    step_ms = []
    sgn = 1.0
    for _ in range(DRIFT_STEPS):
        x, y, z = drifted((x, y, z), drift, sgn)
        (state, counts, res), ms = timed_ms(lambda: step(domain, state, x, y, z))
        step_ms.append(ms)
        check(int(res.overflow) == 0, f"overflow {res.overflow_detail.tolist()}")
        if len(reference) <= POOL_DRIFT_STEPS:
            keep_reference(state, counts, res)
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
                               "bound_by": bounds[k][1]} for k, (ms, p) in times.items()}, \
        (reference, caps["tree"])


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
            readings = tier_timer_readings(new)
            print(f"{name} on path A, level {level}: the timers' readings, ms a call: "
                  f"{json.dumps({k: round(v, 5) for k, v in readings.items()})} [{card}]", flush=True)
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
    keep = {"res": res, "box": state.box, "view": view, "counts": counts[:N]}  # path H's inputs
    return {k: launches[k] for k in ("pairwise_count_runs", "pairwise_count")}, err, times, keep


# ----------------------------------------------------------------------------
# phase 7: path C, a Domain whose focus tree differs from its global tree
# ----------------------------------------------------------------------------

class OpCounter:
    """Counts the torch operations dispatched inside the block and, of
    them, the reads of device values on the host (item, bool, int,
    tolist, a copy to the CPU). A hand-written kernel's launch is not a
    torch operation."""

    def __enter__(self):
        import torch
        from torch.utils._python_dispatch import TorchDispatchMode

        counter = self
        self.ops = self.readbacks = 0

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                counter.ops += 1
                from_card = any(isinstance(a, torch.Tensor) and a.is_cuda for a in args)
                to_host = isinstance(out, torch.Tensor) and not out.is_cuda
                counter.readbacks += "_local_scalar_dense" in str(func) or (from_card and to_host)
                return out

        self._mode = Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self._mode.__exit__(*exc)


class CallCounter:
    """Counts the calls of module.name inside the block; with timed=True
    also sums their time in ms, the card drained before and after each."""

    def __init__(self, module, name, timed=False):
        self.module, self.name, self.timed, self.n, self.ms = module, name, timed, 0, 0.0

    def __enter__(self):
        import torch

        self.real = getattr(self.module, self.name)

        def counted(*a, **k):
            self.n += 1
            if not self.timed:
                return self.real(*a, **k)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self.real(*a, **k)
            torch.cuda.synchronize()
            self.ms += 1e3 * (time.perf_counter() - t0)
            return out

        setattr(self.module, self.name, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def bucket_tree_ok(tree, bucket, what) -> None:
    """The cornerstone fixed point at `bucket`: no leaf above it, and no
    complete group of 8 sibling leaves that would fit into one."""
    from cstone_tpu_torch.ops.keys64 import to_numpy

    nn = int(tree.n_nodes)
    keys = to_numpy(tree.keys)[: nn + 1]
    counts = tree.counts[:nn].cpu().numpy()
    check(int(counts.max()) <= bucket, f"{what}: a leaf holds {int(counts.max())} > {bucket}")
    d = np.diff(keys)
    i = np.arange(max(nn - 7, 0))
    group = np.all(d[i[:, None] + np.arange(8)] == d[i][:, None], axis=1) & (keys[i] % (d[i] * np.uint64(8)) == 0)
    cs = np.concatenate([[0], np.cumsum(counts)])
    sums = (cs[i + 8] - cs[i])[group]
    check(len(sums) > 0 and int(sums.min()) > bucket,
          f"{what}: a sibling group of {int(sums.min()) if len(sums) else -1} particles was not merged")


def focus_tree_phase(dev, card):
    """Phase 7: Domain.sync with a focus tree built by focus_converge."""
    import torch

    from cstone_tpu_torch.domain import Domain
    from cstone_tpu_torch.focus import octree_focus
    from cstone_tpu_torch.ops.cuda_lib import record_launches
    from cstone_tpu_torch.ops.keys64 import to_numpy
    from cstone_tpu_torch.sfc import PERIODIC, make_box
    from cstone_tpu_torch.traversal import cell_list_neighbor_counts, find_neighbors

    xyz, drift, h = uniform_setup(dev)
    box = make_box(0.0, 1.0, boundaries=PERIODIC, device=dev)
    domains = {
        "C": Domain(bucket_size=GLOBAL_BUCKET, bucket_size_focus=BUCKET,
                    tree_capacity=tree_capacity(N, GLOBAL_BUCKET), focus_capacity=tree_capacity(N), device=dev),
        "4": Domain(bucket_size=BUCKET, tree_capacity=tree_capacity(N), device=dev),  # phase 4's
    }
    check(domains["C"].focus_capacity != domains["C"].tree_capacity, "path C needs its own focus capacity")
    states = {k: d.init_state(box=box, boundaries=(1, 1, 1)) for k, d in domains.items()}

    def counts_of(res, state):
        c, ovf = cell_list_neighbor_counts(res.keys, res.x, res.y, res.z, res.h, state.box, LEVEL, CAP,
                                           n_valid=res.end_index, const_h=True)
        check(not bool(ovf), "cell-list cap overflowed")
        return c

    def one_step(xyz):
        """Both Domains on the same positions, in turns: {name: (res,
        counts, sync ms, counts ms, converge iterations, linked builds,
        the recorded launches of the counts)}."""
        out = {}
        for name in tuple(order):
            before = all_launches()
            with CallCounter(octree_focus, "rebalance_decision_essential") as iters, \
                    CallCounter(octree_focus, "build_linked_octree") as builds:
                (state, res), sync_ms = timed_ms(lambda: domains[name].sync(states[name], *xyz, h))
            with record_launches() as calls:
                counts, counts_ms = timed_ms(lambda: counts_of(res, state))
            states[name] = state
            if name == "C":
                add_launches(before)
            out[name] = (res, counts, sync_ms, counts_ms, iters.n, builds.n, calls)
        order.reverse()
        return out

    order = ["C", "4"]
    launches = dict.fromkeys(KERNELS, 0)  # of path C alone, not of the Domain beside it

    def add_launches(before):
        for k, v in all_launches().items():
            launches[k] += v - before[k]

    def same_as_phase_4(out, what):
        (rc, cc), (r4, c4) = out["C"][:2], out["4"][:2]
        check(int(rc.overflow) == 0 and not bool(rc.overflow_detail.any()),
              f"{what}: overflow {rc.overflow_detail.tolist()}")
        check(states["C"].focus_converged, f"{what}: the focus tree did not converge")
        for f in ("keys", "x", "y", "z", "h", "layout", "leaf_counts", "start_index", "end_index"):
            check(torch.equal(getattr(rc, f), getattr(r4, f)), f"{what}: {f} differs from the bucket-{BUCKET} Domain's")
        check(torch.equal(rc.tree.leaves, r4.tree.leaves) and int(rc.tree.n_leaf) == int(r4.tree.n_leaf),
              f"{what}: the focus tree is not the bucket-{BUCKET} cornerstone tree")
        check(torch.equal(rc.tree.prefixes, r4.tree.prefixes)
              and torch.equal(rc.tree.child_offsets, r4.tree.child_offsets), f"{what}: linked focus tree differs")
        check(torch.equal(cc, c4), f"{what}: counts differ from the bucket-{BUCKET} Domain's")
        bucket_tree_ok(states["C"].global_tree, GLOBAL_BUCKET, f"{what}, global tree")
        cornerstone_ok(states["C"].global_tree, N)

    def report(label, out):
        for name in ("C", "4"):
            _, _, sync_ms, counts_ms, iters, builds, _ = out[name]
            tag = (f"path C (buckets {GLOBAL_BUCKET}/{BUCKET}): converge iterations {iters}, linked builds {builds}"
                   if name == "C" else f"bucket-{BUCKET} Domain (phase 4's, fast_focus)")
            print(f"{label}: {tag}: sync {sync_ms:.3f} ms, sync+counts {sync_ms + counts_ms:.3f} ms [{card}]",
                  flush=True)

    reset_all_launches()
    out = one_step(xyz)
    same_as_phase_4(out, "cold step")
    report("cold step", out)
    gt, ft = states["C"].global_tree, out["C"][0].tree
    print(f"global tree {int(gt.n_nodes)} leaves (capacity {gt.keys.shape[0] - 1}), focus tree "
          f"{int(ft.n_leaf)} leaves (capacity {ft.leaves.shape[0] - 1})", flush=True)
    check(int(ft.n_leaf) >= 4 * int(gt.n_nodes), "the focus tree should be much finer than the global tree")

    sgn, warm = 1.0, []
    for i in range(FOCUS_STEPS):
        xyz = drifted(xyz, drift, sgn)
        sgn = -sgn
        out = one_step(xyz)
        if i == FOCUS_STEPS - 1:
            res, state, before = out["C"][0], states["C"], all_launches()
            view = domains["C"].ns_view(res, state.box)
            with record_launches() as calls:
                (nb, _), find_ms = timed_ms(lambda: find_neighbors(
                    res.x, res.y, res.z, res.h, view, state.box, use_pallas="v2", n_targets=N, **NB_KW))
            add_launches(before)
        same_as_phase_4(out, f"drift step {i + 1}")
        report(f"drift step {i + 1}", out)
        warm.append(out)
    rest = one_step(xyz)  # the particles at rest: converged at once
    torch.cuda.synchronize()
    same_as_phase_4(rest, "step at rest")
    report("step at rest", rest)
    check(rest["C"][4] == 1 and rest["C"][5] == 0,
          f"a warm converged step should take 1 iteration and build no linked tree: {rest['C'][4:]}")
    print(f"phase 7 launches (path C): {json.dumps(launches)}", flush=True)
    check(launches["stencil_counts"] == FOCUS_STEPS + 2 and launches["pairwise_count_runs"] == 1,
          f"path C should launch B1 once each step and B5 once: {launches}")
    med = {k: (float(np.median([o[k][2] for o in warm])), float(np.median([sum(o[k][2:4]) for o in warm])))
           for k in ("C", "4")}
    print(f"path C warm steps: {FOCUS_STEPS} drift steps, median sync {med['C'][0]:.3f} ms, sync+counts "
          f"{med['C'][1]:.3f} ms; bucket-{BUCKET} Domain in the same turns: sync {med['4'][0]:.3f} ms, "
          f"sync+counts {med['4'][1]:.3f} ms; find_neighbors v2 on the focus tree {find_ms:.3f} ms [{card}]",
          flush=True)

    # neighbours on the focus tree: the mean, and against the cell list
    res, counts = warm[-1]["C"][:2]
    v2c, cc = nb[:N].long(), counts[:N].long()
    mean_nb = float(v2c.double().mean())
    diff = (v2c - cc).abs()
    print(f"find_neighbors on the focus tree: mean neighbours {mean_nb:.3f}; v2 vs cell list: "
          f"{int((diff > 0).sum())} particles differ, max |diff| {int(diff.max())}", flush=True)
    check(abs(mean_nb - 57.9) <= 0.5, f"mean neighbour count {mean_nb} outside 57.9 +- 0.5")
    check(int((diff > 0).sum()) <= 10 and int(diff.max()) <= 1, "v2 and cell-list counts disagree beyond flips")

    # the last drift step's B1 and B5 launches of path C against their plain versions
    err = Errors()
    mine = calls + warm[-1]["C"][6]
    check([c[0] for c in mine] == ["pairwise_count_runs", "stencil_counts"],
          f"path C's last drift step launched {[c[0] for c in mine]}")
    for name, args, got in mine:
        want, plain_ms = timed_ms(lambda: plain_of(name)(*args))
        err.counts(name, got, want, "path-C inputs")
        print(f"{name} on path C: bit-equal to plain; plain {plain_ms:.4f} ms (one call) [{card}]", flush=True)

    # torch operations and host read-backs of one cold and one warm sync
    for label, make_state in (("cold", lambda k: domains[k].init_state(box=box, boundaries=(1, 1, 1))),
                              ("warm (drifted)", lambda k: states[k])):
        if label != "cold":
            xyz = drifted(xyz, drift, sgn)
        for k in ("C", "4"):
            with OpCounter() as ops:
                domains[k].sync(make_state(k), *xyz, h)
            print(f"{label} sync, {'path C' if k == 'C' else f'bucket-{BUCKET} Domain'}: {ops.ops} torch "
                  f"operations dispatched, {ops.readbacks} host read-backs", flush=True)
    launches = {k: launches[k] for k in ("stencil_counts", "pairwise_count_runs")}
    return launches, err, warm[-1]["C"][0], states["C"]


# ----------------------------------------------------------------------------
# phase 8: path D, one rank's locally essential tree and halos from the pool
# ----------------------------------------------------------------------------

def let_phase(dev, card, res, state):
    """Phase 8: what rank LET_RANK of LET_RANKS does in the pool protocol,
    without collectives, on phase 7's sorted particles and global tree."""
    import torch

    from cstone_tpu_torch.domain.decomposition import make_sfc_assignment
    from cstone_tpu_torch.focus import octree_focus
    from cstone_tpu_torch.focus.source_center import geo_mac_spheres
    from cstone_tpu_torch.ops.keys64 import to_numpy, ule
    from cstone_tpu_torch.ops.primitives import searchsorted, segment_max
    from cstone_tpu_torch.sfc.box import Box
    from cstone_tpu_torch.traversal import macs, traversal
    from cstone_tpu_torch.traversal.collisions import find_halos
    from cstone_tpu_torch.traversal.macs import inv_theta_min_mac, mark_macs
    from cstone_tpu_torch.tree import CsArray, root_tree
    from cstone_tpu_torch.tree.octree import node_keys_and_levels, node_parents

    box, gtree, pool_keys, pool_h = state.box, state.global_tree, res.keys, res.h
    cap_leaf = tree_capacity(N)
    inv_theta = inv_theta_min_mac(LET_THETA)

    traversal.mark_levels_log = []
    t0 = time.perf_counter()
    assignment = make_sfc_assignment(gtree.keys, gtree.counts, gtree.n_nodes, LET_RANKS)
    bnd = assignment.boundaries
    fs, fe = bnd[LET_RANK], bnd[LET_RANK + 1]
    with CallCounter(octree_focus, "rebalance_decision_essential") as iters, \
            CallCounter(macs, "mark_macs", timed=True) as marking:
        leaves, n_leaf, linked, node_counts, overflow, _, converged = octree_focus.focus_converge(
            root_tree(np.uint64, cap_leaf, device=dev).keys, 1, pool_keys, N, box, fs, fe, bnd, BUCKET,
            inv_theta, skip_macs=False)
    lif = torch.arange(cap_leaf, device=dev)
    leaf_counts = torch.where(lif < n_leaf, node_counts[linked.leaf_order()], 0)
    first_leaf, last_leaf = searchsorted(leaves, bnd[LET_RANK:LET_RANK + 2])

    # per-leaf interaction radii: 2 x max h over the leaf's particles, for
    # the rank's own leaves (halos.hpp:116-189)
    leaf_off = torch.clamp(searchsorted(pool_keys, leaves), max=N)
    hmax = torch.clamp(segment_max(pool_h, leaf_off, cap_leaf), min=0.0)  # an empty leaf holds -inf
    mine = (lif >= first_leaf) & (lif < last_leaf)
    radii = torch.where(mine, hmax * 2.0, 0.0)
    build_levels = list(traversal.mark_levels_log)
    halo_flags = find_halos(linked, radii, box, first_leaf, last_leaf)
    torch.cuda.synchronize()
    build_ms = 1e3 * (time.perf_counter() - t0)
    halo_levels = traversal.mark_levels_log[len(build_levels):]
    traversal.mark_levels_log = None
    nl, i0, i1 = int(n_leaf), int(first_leaf), int(last_leaf)
    print(f"rank {LET_RANK} of {LET_RANKS}, theta {LET_THETA}: locally essential tree {nl} leaves, "
          f"{i1 - i0} of them its own, {int(halo_flags.sum())} halo leaves; {iters.n} converge iterations, "
          f"batched_mark levels per call: mark_macs {build_levels}, find_halos {halo_levels}; whole build "
          f"(assignment, focus_converge, radii, find_halos) {build_ms:.3f} ms, of which the {marking.n} "
          f"mark_macs calls {marking.ms:.3f} ms [{card}]", flush=True)

    check(bool(converged) and int(overflow) == 0, f"focus_converge: converged {converged}, overflow {int(overflow)}")
    cornerstone_ok(CsArray(keys=leaves, counts=leaf_counts, n_nodes=n_leaf), N)
    lv = to_numpy(leaves)[: nl + 1]
    check(bool(np.isin(to_numpy(bnd), lv).all()), "an assignment boundary is not a leaf key")

    # inside the rank's range: path C's focus tree; outside: coarser
    full = to_numpy(res.tree.leaves)[: int(res.tree.n_leaf) + 1]
    lo, hi = to_numpy(bnd)[LET_RANK], to_numpy(bnd)[LET_RANK + 1]
    check(np.array_equal(lv[(lv >= lo) & (lv <= hi)], full[(full >= lo) & (full <= hi)]),
          "inside the rank's range the tree is not path C's focus tree")
    n_out, n_out_full = int(((lv < lo) | (lv > hi)).sum()), int(((full < lo) | (full > hi)).sum())
    # outside it the tree is never finer. On a uniform sample whose cells
    # one level up hold more than a bucket it is not coarser either:
    # mark_macs, as in the JAX package, takes every leaf that is not
    # interior to the focus as a target, so each foreign leaf marks its own
    # parent and that parent's neighbours, and the refinement spreads from
    # the focus over the whole box
    print(f"leaf keys outside the rank's range: {n_out} (path C's focus tree: {n_out_full})", flush=True)
    check(n_out <= n_out_full, "outside the rank's range the tree is finer than path C's")

    halo_flags_ok(leaves, n_leaf, radii, box, mine, halo_flags, f"rank {LET_RANK}")

    # MAC marks on the card against the same function on CPU copies
    centers = geo_mac_spheres(linked, inv_theta, box)
    (marks, mark_ms) = timed_ms(lambda: mark_macs(linked, centers, box, fs, fe, leaves, n_leaf, limit_source=True))
    cpu = lambda t: t.cpu()  # noqa: E731
    linked_cpu = dataclasses.replace(linked, **{f.name: cpu(getattr(linked, f.name))
                                                 for f in dataclasses.fields(linked)})
    t0 = time.perf_counter()
    marks_cpu = mark_macs(linked_cpu, cpu(centers), Box(limits=cpu(box.limits), boundaries=box.boundaries),
                          cpu(fs), cpu(fe), cpu(leaves), cpu(n_leaf), limit_source=True)
    cpu_s = time.perf_counter() - t0
    check(torch.equal(marks.cpu(), marks_cpu), f"MAC marks differ between the card and the CPU at "
          f"{int((marks.cpu() != marks_cpu).sum())} nodes")
    marked = torch.nonzero(marks)[:, 0]
    check(bool(marks[node_parents(linked)[marked[marked > 0]]].all()), "a marked node's parent is not marked")
    start, end, _ = node_keys_and_levels(linked)
    inside = ule(fs, start) & ule(end, fe)
    check(not bool(inside[marked].any()), "a node wholly inside the focus is marked")
    check(0 < marked.numel() < int(linked.n_nodes), "the marks should be a proper part of the nodes")
    print(f"mark_macs on the final tree: {marked.numel()} of {int(linked.n_nodes)} nodes marked, equal to "
          f"the CPU run; {mark_ms:.3f} ms on the card, {cpu_s:.3f} s on the CPU [{card}]", flush=True)


# ----------------------------------------------------------------------------
# phase 9: path E, LET_RANKS ranks of the pool protocol on one card
# ----------------------------------------------------------------------------

class RankTimer:
    """Sums, per rank thread, the host time of module.name's calls inside
    the block. The ranks share the card, so no call drains it: a call's
    time is its host time, its own waits on the card included."""

    def __init__(self, module, name):
        self.module, self.name, self.ms = module, name, {}

    def __enter__(self):
        import threading

        self.real = getattr(self.module, self.name)

        def timed(*a, **k):
            t0 = time.perf_counter()
            try:
                return self.real(*a, **k)
            finally:
                me = threading.current_thread().name
                self.ms[me] = self.ms.get(me, 0.0) + 1e3 * (time.perf_counter() - t0)

        setattr(self.module, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


class RankTally:
    """Counts one rank's all_to_all, ragged_all_to_all and ppermute rounds
    and the bytes it sends in them, by wrapping the methods of its own comm
    (a thread's RankComm or a process's DistComm alike): an all_to_all
    sends its (n_ranks, ...) buffer, its own row included, a ragged round
    the rows of its chunks, summed on the card without a host read, a
    ppermute round its tensor where a pair names the rank as a source. A
    DistComm under gloo also counts its host staging (staged_bytes)."""

    def __init__(self, comm):
        self.comm = comm
        a2a, ragged, ppermute = comm.all_to_all, comm.ragged_all_to_all, comm.ppermute
        self.reset()

        def all_to_all(t):
            self.rounds += 1
            self.nbytes += t.numel() * t.element_size()
            return a2a(t)

        def ragged_all_to_all(operand, output, input_offsets, send_sizes, output_offsets, recv_sizes):
            self.ragged_rounds += 1
            row = operand[0].numel() * operand.element_size()
            self.ragged_bytes = self.ragged_bytes + send_sizes.clamp(min=0).sum() * row
            return ragged(operand, output, input_offsets, send_sizes, output_offsets, recv_sizes)

        def permute(t, pairs):
            self.ppermute_rounds += 1
            if any(src == comm.rank for src, _ in pairs):
                self.ppermute_bytes += t.numel() * t.element_size()
            return ppermute(t, pairs)

        comm.all_to_all, comm.ragged_all_to_all, comm.ppermute = all_to_all, ragged_all_to_all, permute
        comm.tally = self

    @classmethod
    def of(cls, comm) -> "RankTally":
        """The comm's tally, attached at the first call."""
        return getattr(comm, "tally", None) or cls(comm)

    def reset(self):
        self.rounds = self.nbytes = self.ragged_rounds = self.ragged_bytes = 0
        self.ppermute_rounds = self.ppermute_bytes = 0
        self.staged0 = getattr(self.comm, "staged_bytes", 0)

    def read(self) -> dict:
        return {"all_to_all": self.rounds, "all_to_all_bytes": self.nbytes, "ragged": self.ragged_rounds,
                "ragged_bytes": int(self.ragged_bytes), "ppermute": self.ppermute_rounds,
                "ppermute_bytes": self.ppermute_bytes,
                "staged_bytes": getattr(self.comm, "staged_bytes", 0) - self.staged0}


def ranks_setup(dev):
    """Phase 4's 1M positions, drift and h on dev, with mass 1/N, the
    particle ids and the periodic unit box: the inputs of paths E-G."""
    import torch

    from cstone_tpu_torch.sfc import PERIODIC, make_box

    xyz, drift, h = uniform_setup(dev)
    return {"xyz": xyz, "drift": drift, "h": h, "m": torch.full((N,), 1.0 / N, dtype=torch.float32, device=dev),
            "ids": torch.arange(N, device=dev), "box": make_box(0.0, 1.0, boundaries=PERIODIC, device=dev)}


def rank_input(setup, r, cap):
    """Rank r of LET_RANKS starts from the strided slice r::LET_RANKS of
    every field, padded to cap: the exchange moves nearly every
    particle."""
    import torch

    def pad(a, fill):
        out = torch.full((cap,), fill, dtype=a.dtype, device=a.device)
        s = a[r::LET_RANKS]
        out[:s.numel()] = s
        return out

    ids = setup["ids"]
    return {"xyz": tuple(pad(c, 0.0) for c in setup["xyz"]), "h": pad(setup["h"], 0.0), "m": pad(setup["m"], 0.0),
            "ids": pad(ids, -1), "n": torch.tensor(ids[r::LET_RANKS].numel(), device=ids.device)}


def drift_input(inp, drift, sgn):
    """A rank's next input: its particles moved by the drift of their ids."""
    return dict(inp, xyz=tuple((c + sgn * drift[inp["ids"].clamp(min=0), i]) % 1.0
                               for i, c in enumerate(inp["xyz"])))


def make_domain(comm, caps, mode, protocol, dev, window=0):
    """A rank's Domain; the p2p capacities 0 take the Domain's defaults,
    and "halo" is both the request and the particle capacity; `window`
    is the dense protocol's peer window (0: none)."""
    from cstone_tpu_torch.domain import Domain

    return Domain(bucket_size=BUCKET, tree_capacity=caps["tree"], focus_capacity=caps["focus"], theta=LET_THETA,
                  exchange_mode=mode, protocol=protocol, comm=comm, device=dev, move_cap=caps["move"],
                  treelet_cap=caps["treelet"], halo_req_cap=caps["halo"], halo_cap=caps["halo"], peer_window=window)


def rank_sync(comm, domain, state, inp):
    """One rank's sync between two barriers: (state, res, (start, end))
    on the host clock, the rank's stream drained."""
    import torch

    comm.all_reduce_flag(True)  # start together
    t0 = time.perf_counter()
    state, res = domain.sync(state, *inp["xyz"], inp["h"], properties=(inp["m"],), n_local=inp["n"])
    torch.cuda.current_stream().synchronize()
    return state, res, (t0, time.perf_counter())


def rank_after(comm, domain, state, res, inp):
    """B1 and B2 on the rank's buffer, the ids of its slots (p2p: the
    owned ones, halo slots 0), the ids exchange_halos puts into the halo
    slots, and the next step's input (the owned particles, by
    compact_owned)."""
    import torch

    from cstone_tpu_torch.traversal import cell_list_neighbor_counts, cell_list_sph_density

    rid = domain.reapply_sync(res, inp["ids"])
    counts, c_ovf = cell_list_neighbor_counts(res.keys, res.x, res.y, res.z, res.h, state.box, LEVEL, CAP,
                                              n_valid=res.n_with_halos, impl="pallas")
    rho, d_ovf = cell_list_sph_density(res.keys, res.x, res.y, res.z, res.h, state.box, LEVEL, CAP,
                                       mass=res.properties[0], n_valid=res.n_with_halos)
    j = torch.arange(rid.shape[0], device=rid.device)
    owned = (j >= res.start_index) & (j < res.end_index)
    halo_ids = domain.exchange_halos(res, torch.where(owned, rid, -1))
    co = domain.compact_owned
    nxt = {"xyz": tuple(co(res, c) for c in (res.x, res.y, res.z)), "h": co(res, res.h),
           "m": co(res, res.properties[0]), "ids": co(res, rid), "n": res.end_index - res.start_index}
    return {"rid": rid, "counts": counts, "rho": rho, "halo_ids": halo_ids,
            "cell_ovf": bool(c_ovf | d_ovf), "next": nxt}


def cold_step(comm, setup, caps0, mode, protocol):
    """The cold step: the rank runs the capacity retry itself; every rank
    reports the largest overflow of all ranks and so takes the same retry.
    Returns (state, res, span, input, domain, capacities, the comm's
    RankTally, reset before the step: the step's rounds and bytes)."""
    tally = RankTally.of(comm)
    tally.reset()

    def run(caps):
        domain = make_domain(comm, caps, mode, protocol, setup["ids"].device)  # kept across steps
        state = domain.init_state(box=setup["box"], boundaries=(1, 1, 1))
        inp = rank_input(setup, comm.rank, caps["local"])
        state, res, span = rank_sync(comm, domain, state, inp)
        return state, span, inp, domain, res  # the SyncResult last, for sync_with_retry

    from cstone_tpu_torch.domain import sync_with_retry

    (state, span, inp, domain, res), caps = sync_with_retry(run, caps0)
    return state, res, span, inp, domain, caps, tally


def first_caps(tree_cap):
    return {"local": POOL_LOCAL_CAP, "tree": tree_cap, "focus": tree_cap, "move": 0, "treelet": 0, "halo": 0}


def hold_to_plain(err, calls, what) -> None:
    """Every recorded launch (record_launches) against its plain version on
    the same inputs: counts exactly, densities within rtol 1e-5."""
    for k, args, got in calls:
        (err.density if k.endswith("density") else err.counts)(k, got, plain_of(k)(*args), what)


def path_record(states, results, after):
    """What a later path is held to at one step, per rank."""
    return [{"boundaries": st.assignment.boundaries, "leaves": res.tree.leaves[:int(res.tree.n_leaf) + 1],
             "halo_flags": res.halo_flags, "layout": res.layout, "n_with_halos": int(res.n_with_halos),
             "halo_ids": a["halo_ids"][:int(res.n_with_halos)]}
            for st, res, a in zip(states, results, after)]


def ranks_phase(dev, card, reference, tree_cap, mode, path_e=None):
    """Phases 9 and 10: LET_RANKS ranks of Domain(exchange_mode=mode) as
    threads of this process (parallel.run_ranks), all on the one card,
    then B1 and B2 on every rank's buffer; checked against phase 4's
    single-rank run on the same positions and, for path F (mode "p2p"),
    against path E's record of the same rank and step (`path_e`).
    Returns (B1/B2 launches, Errors, this path's record: per step, per
    rank, what path F is held to, the sync walls, per step the ranks' own
    sync ms, all_to_all rounds and buffer bytes, and the peak memory)."""
    import torch

    from cstone_tpu_torch.ops.cuda_lib import record_launches
    from cstone_tpu_torch.parallel import run_ranks
    from cstone_tpu_torch.traversal import macs

    R = LET_RANKS
    name = "E" if mode == "pool" else "F"
    setup = ranks_setup(dev)
    box = setup["box"]
    torch.cuda.reset_peak_memory_stats(dev)
    caps0 = first_caps(tree_cap)

    reset_all_launches()
    t0 = time.perf_counter()
    with RankTimer(macs, "mark_macs") as marking:
        outs = run_ranks(R, lambda comm: cold_step(comm, setup, caps0, mode, "dense"))
    caps, tallies = outs[0][5], [o[6] for o in outs]
    print(f"path {name}: {R} ranks, {mode} mode, theta {LET_THETA}: cold sync with retry "
          f"{1e3 * (time.perf_counter() - t0):.3f} ms, capacities {caps} [{card}]", flush=True)
    check(all(o[5] == caps for o in outs), "the ranks grew different capacities")
    check(caps == caps0, f"the first capacities {caps0} overflowed: {caps}")
    check(all(torch.equal(o[1].overflow_detail, outs[0][1].overflow_detail) for o in outs),
          "the ranks report different overflows")
    if mode == "pool":
        n_pool = R * caps["local"]
        print(f"pool per rank: {n_pool} slots, {n_pool * (8 + 8 + 4 * 5)} bytes of keys, permutation and "
              f"payload; torch.cuda.device_count() {torch.cuda.device_count()} [{card}]", flush=True)

    err = Errors()
    states, results, spans, inputs, domains = ([o[i] for o in outs] for i in range(5))
    record, walls, rank_ms, comm_rounds, comm_bytes = [], [], [], [], []
    sgn = 1.0
    for step in range(1 + POOL_DRIFT_STEPS):
        what = f"path {name}, " + ("cold step" if step == 0 else f"drift step {step}")
        if step > 0:
            inputs = [drift_input(inp, setup["drift"], sgn) for inp in inputs]
            sgn = -sgn
            for t in tallies:
                t.reset()
            with RankTimer(macs, "mark_macs") as marking:
                outs = run_ranks(R, rank_sync, domains, states, inputs)
            states, results, spans = ([o[i] for o in outs] for i in range(3))
        stats = [t.read() for t in tallies]  # the sync's, before exchange_halos' round
        last = step == POOL_DRIFT_STEPS
        with record_launches() as calls:
            after = run_ranks(R, rank_after, domains, states, results, inputs)
        if last:
            launched = list(calls)
        wall = 1e3 * (max(e for _, e in spans) - min(s for s, _ in spans))
        walls.append(wall)
        per_rank = [1e3 * (e - s) for s, e in spans]
        rank_ms.append(per_rank)
        mark = [marking.ms.get(f"rank-{r}", 0.0) for r in range(R)]
        print(f"{what}: {R}-rank sync wall {wall:.3f} ms; per rank sync ms {json.dumps([round(t, 3) for t in per_rank])}, "
              f"share in mark_macs {json.dumps([round(a / b, 4) for a, b in zip(mark, per_rank)])} [{card}]",
              flush=True)
        rounds, nbytes = [x["all_to_all"] for x in stats], [x["all_to_all_bytes"] for x in stats]
        comm_rounds.append(rounds)
        comm_bytes.append(nbytes)
        print(f"{what}: all_to_all rounds per rank {json.dumps(rounds)}, their buffer bytes per rank "
              f"{json.dumps(nbytes)}; overflow_detail {results[0].overflow_detail.tolist()}", flush=True)
        pool_checks(what, reference[step], states, results, after, box, mode == "pool", card)
        record.append(path_record(states, results, after))
        if path_e is not None:
            same_as_path_e(what, path_e["record"][step], record[step])
        inputs = [a["next"] for a in after]
    launches = all_launches()
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"path {name} launches: {json.dumps(launches)}; peak memory allocated "
          f"{peak} bytes [{card}]", flush=True)
    for k in ("stencil_counts", "stencil_density"):
        check(launches[k] == R * (1 + POOL_DRIFT_STEPS), f"{k} should launch once per rank and step: {launches}")
    if path_e is not None:
        print(f"8-rank sync wall ms, cold then drift steps: path E {json.dumps([round(t, 3) for t in path_e['walls']])}, "
              f"path F {json.dumps([round(t, 3) for t in walls])} [{card}]", flush=True)

    # every B1 and B2 launch of the last step against its plain version
    names = sorted(c[0] for c in launched)
    check(names == ["stencil_counts"] * R + ["stencil_density"] * R, f"the last step launched {names}")
    hold_to_plain(err, launched, f"path-{name} inputs")
    print(f"path {name}: the last step's {len(launched)} B1/B2 launches equal their plain versions", flush=True)
    return ({k: launches[k] for k in ("stencil_counts", "stencil_density")}, err,
            {"record": record, "walls": walls, "rank_ms": rank_ms, "rounds": comm_rounds, "bytes": comm_bytes,
             "peak": peak})


# ----------------------------------------------------------------------------
# phase 11: path G, the ranks as processes on the one card
# ----------------------------------------------------------------------------

def rank_record(state, res, after, span, comm_stats) -> dict:
    """What the parent checks of one rank process's step (copies, so that
    pickling sends no more than these)."""
    nn, nwh = int(state.global_tree.n_nodes), int(res.n_with_halos)
    return {"span": span, "comm": comm_stats, "overflow": int(res.overflow),
            "overflow_detail": res.overflow_detail.tolist(), "cell_ovf": after["cell_ovf"],
            "tree": (nn, state.global_tree.keys[:nn + 1].clone(), state.global_tree.counts[:nn].clone()),
            "boundaries": state.assignment.boundaries, "leaves": res.tree.leaves[:int(res.tree.n_leaf) + 1].clone(),
            "halo_flags": res.halo_flags, "layout": res.layout, "n_with_halos": nwh,
            "start": int(res.start_index), "end": int(res.end_index), "keys": res.keys[:nwh].clone(),
            **{k: after[k][:nwh].clone() for k in ("rid", "halo_ids", "counts", "rho")}}


def path_g_rank(comm, tree_cap):
    """One rank process of path G (run by parallel.dist.spawn_ranks): (a)
    the multi-rank dry run in both protocols, which also takes the
    process's first syncs; (b) path F's steps in the p2p mode, with the
    dense protocol, then with the ragged one; B1 and B2 on the rank's
    buffer after each sync. Every B5 launch of (a) and the last step's
    launches of (b) are held to their plain versions here, (b)'s after
    the peak memory is read."""
    import torch

    from cstone_tpu_torch import multichip
    from cstone_tpu_torch.ops import neighbors_v1, neighbors_v2, stencil
    from cstone_tpu_torch.ops.cuda_lib import record_launches

    libs = (stencil.SYM_LIBRARY, stencil.LIBRARY, neighbors_v2.LIBRARY, neighbors_v1.LIBRARY)
    for lib in libs:
        lib.load()  # the libraries phase 2 built: loaded, never built here
    out = {"built": [lib.source.name for lib in libs if lib.build_log]}
    t0 = time.perf_counter()
    with record_launches() as calls:
        out["dry"] = {p: multichip.rank_step(comm, p) for p in multichip.PROTOCOLS}
    out["dry_span"] = (t0, time.perf_counter())
    err = Errors()
    hold_to_plain(err, calls, f"path-G (a) inputs, rank {comm.rank}")
    out["dry_err"], out["dry_launched"] = err.max, sorted(c[0] for c in calls)
    out["dry_shapes"] = [tuple(args[0].shape[:2]) + tuple(args[2].shape[1:]) for _, args, _ in calls]
    dev = comm.device
    setup = ranks_setup(dev)
    for protocol in ("dense", "ragged"):
        torch.cuda.reset_peak_memory_stats(dev)
        reset_all_launches()
        state, res, span, inp, domain, caps, tally = cold_step(comm, setup, first_caps(tree_cap), "p2p", protocol)
        steps, sgn = [], 1.0
        for step in range(1 + POOL_DRIFT_STEPS):
            if step > 0:
                inp = drift_input(inp, setup["drift"], sgn)
                sgn = -sgn
                tally.reset()
                state, res, span = rank_sync(comm, domain, state, inp)
            stats = tally.read()
            with record_launches() as calls:
                after = rank_after(comm, domain, state, res, inp)
            steps.append(rank_record(state, res, after, span, stats))
            inp = after["next"]
        launches = all_launches()
        peak = torch.cuda.max_memory_allocated(dev)
        err = Errors()
        hold_to_plain(err, calls, f"path-G inputs, rank {comm.rank}")  # the last step's launches
        out[protocol] = {"caps": caps, "steps": steps, "launches": launches, "err": err.max,
                         "last_launched": sorted(c[0] for c in calls), "peak": peak}
    return out


def rank_views(recs):
    """pool_checks' (states, results, after) of path G's rank records."""
    import torch
    from types import SimpleNamespace as NS

    states, results, after = [], [], []
    for rec in recs:
        nn, keys, counts = rec["tree"]
        states.append(NS(global_tree=NS(n_nodes=nn, keys=keys, counts=counts),
                         assignment=NS(boundaries=rec["boundaries"])))
        results.append(NS(overflow=rec["overflow"], overflow_detail=torch.tensor(rec["overflow_detail"]),
                          start_index=rec["start"], end_index=rec["end"], n_with_halos=rec["n_with_halos"],
                          keys=rec["keys"]))
        after.append({k: rec[k] for k in ("cell_ovf", "rid", "halo_ids", "counts", "rho")})
    return states, results, after


def processes_phase(dev, card, reference, tree_cap, path_f):
    """Phase 11, path G: LET_RANKS rank processes on the one card
    (parallel.dist.spawn_ranks, gloo), each running (a) the multi-rank dry
    run of cstone_tpu_torch.multichip in both protocols, checked here
    against brute force, then (b) path F's inputs and steps with the
    dense, then the ragged protocol, checked against phase 4 and path F
    (dense) and the dense run (ragged). Returns (launches summed over the
    rank processes: B5 of (a), B1 and B2 of (b); Errors)."""
    import os

    from cstone_tpu_torch import multichip
    from cstone_tpu_torch.parallel.dist import spawn_ranks

    R = LET_RANKS
    cores = f"host cores {os.cpu_count()}, {len(os.sched_getaffinity(0))} usable"
    print(f"path G: {R} rank processes on the one card over gloo (nccl refuses two ranks on one device): "
          f"every collective's CUDA operand is copied to host memory and back; {cores} [{card}]", flush=True)

    t0 = time.perf_counter()
    outs = spawn_ranks(R, path_g_rank, [tree_cap] * R, backend="gloo", device=dev, timeout=600.0, deadline=900.0)
    print(f"path G: {R} rank processes, (a) and (b) in both protocols, {1e3 * (time.perf_counter() - t0):.3f} ms "
          f"with the processes' start [{card}]", flush=True)

    # (a) the multi-rank dry run, both protocols, B5 on every rank
    dry = [o["dry"] for o in outs]
    multichip.check_run(dry[0], R, multichip.N_PER, multichip.expected_sum(R, multichip.N_PER))
    b5 = sum(d[p]["launches"]["pairwise_count_runs"] for d in dry for p in multichip.PROTOCOLS)
    check(all(d[p]["launches"]["pairwise_count_runs"] == 1 for d in dry for p in multichip.PROTOCOLS),
          "path G (a): B5 did not launch once in every rank and protocol")
    check(all(o["dry_launched"] == ["pairwise_count_runs"] * len(multichip.PROTOCOLS) for o in outs),
          f"path G (a): the rank processes recorded {[o['dry_launched'] for o in outs]}")
    err = Errors()
    for o in outs:
        for k, v in o["dry_err"].items():
            err.max[k] = max(err.max[k], v)
    print(f"path G (a): the {b5} B5 launches equal their plain versions (held in each rank process); their "
          f"(groups, group size, run cap) per rank, dense then ragged: "
          f"{json.dumps([o['dry_shapes'] for o in outs])} [{card}]", flush=True)
    for p in multichip.PROTOCOLS:
        o = dry[0][p]
        print(f"path G (a), the dry run of multichip.py, {R} ranks of {multichip.N_PER}, {p}: neighbour sum "
              f"{o['total']} equals brute force, {o['n_assigned']} assigned, overflow 0, {o['alive']} ranks; per rank "
              f"sync+count ms {json.dumps([round(d[p]['sync_and_count_ms'], 3) for d in dry])} (the dense run "
              f"first: each process's first sync) [{card}]", flush=True)
    spans = [o["dry_span"] for o in outs]
    print(f"path G (a): {1e3 * (max(e for _, e in spans) - min(s for s, _ in spans)):.3f} ms for both protocols, "
          f"B5 launches {b5}", flush=True)

    # (b) path F's inputs and steps in the rank processes, dense then ragged
    check(all(not o["built"] for o in outs), f"a rank process built a kernel: {[o['built'] for o in outs]}")
    launches = {k: 0 for k in KERNELS}
    launches["pairwise_count_runs"] = b5
    caps0 = first_caps(tree_cap)
    dense_record = []
    for protocol in ("dense", "ragged"):
        check(all(o[protocol]["caps"] == caps0 for o in outs), f"path G {protocol}: the first capacities "
              f"{caps0} overflowed: {[o[protocol]['caps'] for o in outs]}")
        for step in range(1 + POOL_DRIFT_STEPS):
            what = f"path G, {protocol}, " + ("cold step" if step == 0 else f"drift step {step}")
            recs = [o[protocol]["steps"][step] for o in outs]
            spans = [rec["span"] for rec in recs]
            wall = 1e3 * (max(e for _, e in spans) - min(s for s, _ in spans))
            per_rank = [round(1e3 * (e - s), 3) for s, e in spans]
            print(f"{what}: {R}-process sync wall {wall:.3f} ms (path F {path_f['walls'][step]:.3f}); per rank "
                  f"sync ms {json.dumps(per_rank)} (path F {json.dumps([round(t, 3) for t in path_f['rank_ms'][step]])}) "
                  f"[{card}]", flush=True)
            c = [rec["comm"] for rec in recs]
            print(f"{what}: per rank all_to_all rounds {json.dumps([x['all_to_all'] for x in c])}, bytes "
                  f"{json.dumps([x['all_to_all_bytes'] for x in c])}; ragged rounds {json.dumps([x['ragged'] for x in c])}, "
                  f"bytes {json.dumps([x['ragged_bytes'] for x in c])}; sent a sync "
                  f"{json.dumps([x['all_to_all_bytes'] + x['ragged_bytes'] for x in c])} (path F: rounds "
                  f"{json.dumps(path_f['rounds'][step])}, bytes {json.dumps(path_f['bytes'][step])}); staged through "
                  f"host memory {json.dumps([x['staged_bytes'] for x in c])}; overflow_detail {recs[0]['overflow_detail']}",
                  flush=True)
            pool_checks(what, reference[step], *rank_views(recs), None, False, card)
            record = [{k: rec[k] for k in ("boundaries", "leaves", "halo_flags", "layout", "n_with_halos", "halo_ids")}
                      for rec in recs]
            if protocol == "dense":
                same_as_path_e(what, path_f["record"][step], record, "path F")
                dense_record.append(record)
            else:
                same_as_path_e(what, dense_record[step], record, "the dense protocol")
        runs = [o[protocol]["launches"] for o in outs]
        for k in ("stencil_counts", "stencil_density"):
            check(all(r[k] == 1 + POOL_DRIFT_STEPS for r in runs), f"path G {protocol}: {k} should launch once a "
                  f"step in every rank: {[r[k] for r in runs]}")
            launches[k] += sum(r[k] for r in runs)
        check(all(o[protocol]["last_launched"] == ["stencil_counts", "stencil_density"] for o in outs),
              f"path G {protocol}: the last step launched {[o[protocol]['last_launched'] for o in outs]}")
        for o in outs:
            for k, v in o[protocol]["err"].items():
                err.max[k] = max(err.max[k], v)
        print(f"path G {protocol}: the last step's {2 * R} B1/B2 launches equal their plain versions; peak memory "
              f"allocated per process {json.dumps([o[protocol]['peak'] for o in outs])} bytes (path F, 8 threads in "
              f"one process: {path_f['peak']}) [{card}]", flush=True)
    print(f"path G launches, summed over the rank processes: {json.dumps(launches)}", flush=True)
    return launches, err


# ----------------------------------------------------------------------------
# phase 12: path H, bench.py fn mode's other feeds of B5
# ----------------------------------------------------------------------------

# bench.py's BENCH_GROUP, BENCH_TABLE_LEVEL, BENCH_CELLS_PER_DIM and
# cand_leaf_cap (:535-537, :654-657); run_cap and frontier_cap are NB_KW's
FN_GROUP, TABLE_LEVEL, CELLS_PER_DIM, DFS_LEAF_CAP = 256, 6, 8, 320


def fn_groups(xs, ys, zs, hs, n, G):
    """bench.py's s_groups (:594-612) over the first n sorted particles:
    (targets (n_groups, G, 3), r2, centres, half sizes, radii 2 max h)."""
    import torch

    n_groups = -(-n // G)
    pad = n_groups * G - n
    gx, gy, gz, gh = (torch.cat([a[:n], a.new_zeros(pad)]).reshape(n_groups, G) for a in (xs, ys, zs, hs))
    gvalid = torch.arange(n_groups * G, device=xs.device).reshape(n_groups, G) < n
    big = float(np.finfo(np.float32).max)
    gmin = torch.stack([torch.where(gvalid, a, big).amin(1) for a in (gx, gy, gz)], -1)
    gmax = torch.stack([torch.where(gvalid, a, -big).amax(1) for a in (gx, gy, gz)], -1)
    gr = 2.0 * torch.where(gvalid, gh, 0.0).amax(1)
    r2 = torch.where(gvalid, (2.0 * gh) * (2.0 * gh), -1.0)
    return torch.stack([gx, gy, gz], -1), r2, (gmin + gmax) * 0.5, (gmax - gmin) * 0.5, gr


def run_pairs(r2, run_len) -> int:
    """Candidate pairs B5 tests: live targets times the group's run lengths."""
    return int(((r2 >= 0).sum(dim=1).double() * run_len.sum(dim=1).double()).sum())


def fn_feeds_phase(dev, card, p6):
    """Phase 12, path H: B5 fed by bench.py fn mode's grid cover
    (BENCH_TRAV=cover, :677-683, :781-788) and depth-first walk (:658-667)
    on phase 6's last sync (the same sorted particles), the counts of both
    routes held to phase 6's "v2" counts. Returns (B5 launches, Errors,
    times)."""
    import torch

    from cstone_tpu_torch.ops import neighbors_v2
    from cstone_tpu_torch.ops.cuda_lib import record_launches
    from cstone_tpu_torch.ops.neighbors_v2 import merge_leaf_runs, pairwise_count_runs
    from cstone_tpu_torch.traversal.boxoverlap import min_distance_boxes
    from cstone_tpu_torch.traversal.cover import build_cell_table, group_cover_runs
    from cstone_tpu_torch.traversal.traversal import batched_collect_leaves, batched_collect_leaves_bfs

    res, box, view, v2 = p6["res"], p6["box"], p6["view"], p6["counts"]
    xs, ys, zs = res.x, res.y, res.z
    targets, r2, gc, gs, gr = fn_groups(xs, ys, zs, res.h, N, FN_GROUP)
    n_groups = targets.shape[0]
    lengths = box.lengths.to(torch.float32)
    box_params = torch.cat([lengths, 1.0 / lengths, torch.as_tensor(box.periodic_mask, dtype=torch.float32,
                                                                      device=dev)])
    run_cap = NB_KW["run_cap"]
    tree = view.tree

    def crit(q, nid):  # bench.py's s_traverse criterion
        d = min_distance_boxes(gc[q], gs[q], view.centers[nid], view.sizes[nid], box)
        return d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2] < gr[q] * gr[q]

    def runs_of(leaves, n_cand):
        leaf_idx = torch.where(leaves >= 0, tree.internal_to_leaf[torch.clamp(leaves, min=0)], 0)
        return merge_leaf_runs(leaf_idx, n_cand, view.layout, run_cap)

    ms = {}
    reset_all_launches()
    with record_launches() as calls:
        table, ms["table"] = timed_ms(lambda: build_cell_table(res.keys, TABLE_LEVEL, n_valid=N))
        (cs, cl, cn, c_ovf), ms["cover"] = timed_ms(lambda: group_cover_runs(
            gc - gs, gc + gs, gr, table, TABLE_LEVEL, box, np.uint64, cells_per_dim=CELLS_PER_DIM,
            run_cap=run_cap))
        cover_counts = pairwise_count_runs(targets, r2, cs, cl, xs, ys, zs, box_params)
        (leaves, n_cand), ms["walk"] = timed_ms(lambda: batched_collect_leaves(
            tree.child_offsets, crit, n_groups, DFS_LEAF_CAP))
        (ds, dl, dn, d_ovf), ms["merge"] = timed_ms(lambda: runs_of(leaves, n_cand))
        walk_counts = pairwise_count_runs(targets, r2, ds, dl, xs, ys, zs, box_params)
    torch.cuda.synchronize()
    launches = all_launches()
    print(f"phase 12 launches (path H): {json.dumps(launches)}", flush=True)
    check(launches["pairwise_count_runs"] == 2, f"B5 should launch once per route on path H: {launches}")

    check(not bool(c_ovf) and int(cn.max()) <= run_cap, f"cover runs overflow: largest {int(cn.max())}")
    check(int(n_cand.max()) <= DFS_LEAF_CAP, f"depth-first walk leaves overflow: {int(n_cand.max())}")
    check(not bool(d_ovf) and int(dn.max()) <= run_cap, f"walk runs overflow: largest {int(dn.max())}")
    for name, counts in (("cover", cover_counts), ("depth-first", walk_counts)):
        check(torch.equal(counts.reshape(-1)[:N], v2[:N]),
              f"path H {name} counts differ from phase 6's v2 counts at "
              f"{int((counts.reshape(-1)[:N] != v2[:N]).sum())} particles")
    print(f"path H: {N} particles, {n_groups} groups of {FN_GROUP}; counts by particle of the cover and the "
          f"depth-first routes bit-equal to phase 6's v2 counts; largest runs a group: cover {int(cn.max())}, "
          f"depth-first {int(dn.max())} (run cap {run_cap}); largest leaves a group {int(n_cand.max())} "
          f"(cap {DFS_LEAF_CAP})", flush=True)

    # phase 6's breadth-first route on the same groups, for its times
    (bl, bn, bf), ms["bfs walk"] = timed_ms(lambda: batched_collect_leaves_bfs(
        tree.child_offsets, crit, n_groups, DFS_LEAF_CAP, NB_KW["frontier_cap"]))
    check(int(bf.max()) <= NB_KW["frontier_cap"], "the breadth-first frontier overflowed")
    check(torch.equal(bn, n_cand), "the breadth-first and depth-first walks collect different leaf counts")
    (bfs_start, bfs_len, _, _), ms["bfs merge"] = timed_ms(lambda: runs_of(bl, bn))

    # each route's B5 launch against its plain version, timed at its shape
    check([c[0] for c in calls] == ["pairwise_count_runs"] * 2, f"path H launched {[c[0] for c in calls]}")
    err = Errors()
    times = {}
    for (name, args, got), route in zip(calls, ("cover", "depth-first")):
        err.counts(name, got, plain_of(name)(*args), f"path-H {route} inputs")
        times[route] = cuda_time_ms(lambda: neighbors_v2.pairwise_count_runs(*args), 10)
    bfs_args = (targets, r2, bfs_start, bfs_len, xs, ys, zs, box_params)
    times["breadth-first"] = cuda_time_ms(lambda: neighbors_v2.pairwise_count_runs(*bfs_args), 10)
    pairs = {"cover": run_pairs(r2, cl), "depth-first": run_pairs(r2, dl), "breadth-first": run_pairs(r2, bfs_len)}
    print(f"path H: the cover's and the depth-first walk's B5 launches equal their plain versions", flush=True)
    print(f"path H ms (CUDA events): {json.dumps({k: round(v, 4) for k, v in ms.items()})}; B5 ms on each "
          f"route's runs, 10 launches each: {json.dumps({k: round(v, 4) for k, v in times.items()})}; "
          f"candidate pairs B5 tests: {json.dumps(pairs)} [{card}]", flush=True)
    return {"pairwise_count_runs": launches["pairwise_count_runs"]}, err, {"ms": ms, "b5_ms": times,
                                                                            "pairs": pairs}


# ----------------------------------------------------------------------------
# phase 13: path I, the clients: the simulation loop and gravity
# ----------------------------------------------------------------------------

SIM_DT = 2e-3
SIM_STEPS = 5  # after the cold step
SIM_RANK_STEPS = 2
SIM_NG_MAX = 96  # JAX's default; raised once if the cold step overflows
GRAV_THETA = 0.4
GRAV_SAMPLE = 1024


class SpanTimer:
    """Sums the CUDA-event ms of module.name's calls inside the block
    (one thread; the calls queue on the current stream)."""

    def __init__(self, module, name):
        self.module, self.name, self.ms = module, name, 0.0

    def __enter__(self):
        self.real = getattr(self.module, self.name)

        def timed(*a, **k):
            out, ms = timed_ms(lambda: self.real(*a, **k))
            self.ms += ms
            return out

        setattr(self.module, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def sim_setup(dev):
    """Phase 4's 1M positions and h with velocities normal(0, 0.05) from
    seed 42, minus their mean."""
    import torch

    xyz, _, h = uniform_setup(dev)
    vel = np.random.RandomState(SEED).normal(0.0, 0.05, size=(N, 3)).astype(np.float32)
    vel -= vel.mean(axis=0, keepdims=True)
    v = tuple(torch.from_numpy(np.ascontiguousarray(vel[:, i])).to(dev) for i in range(3))
    return xyz, h, v, float(np.abs(vel).sum())


def sim_rank_steps(comm, xyz, h, v, box, caps, ng_max):
    """One rank of path I (a): rank r's strided slice r::LET_RANKS, a cold
    step and SIM_RANK_STEPS steps; per step (energy, momentum, overflow,
    n_local, host span)."""
    import torch

    from cstone_tpu_torch.models import sim_init, sim_step

    def part(a):
        out = torch.zeros(caps["local"], dtype=a.dtype, device=a.device)
        s = a[comm.rank::LET_RANKS]
        out[:s.numel()] = s
        return out

    domain = make_domain(comm, caps, "p2p", "dense", h.device)
    n = h[comm.rank::LET_RANKS].numel()
    state = sim_init(domain.init_state(box=box, boundaries=(1, 1, 1)), *(part(c) for c in xyz), part(h),
                     *(part(c) for c in v), n)
    out = []
    for _ in range(1 + SIM_RANK_STEPS):
        comm.all_reduce_flag(True)  # start together
        t0 = time.perf_counter()
        state, e, p, ovf = sim_step(domain, state, SIM_DT, ng_max=ng_max)
        torch.cuda.current_stream().synchronize()
        out.append((float(e), p.cpu(), int(ovf), int(state.n_local), (t0, time.perf_counter())))
    return out


def simulation_phase(dev, card, tree_cap):
    """Phase 13 (a): the simulation loop at one rank, then on LET_RANKS
    ranks as threads with path F's capacities, held to the one-rank run."""
    import torch

    from cstone_tpu_torch.domain import Domain
    from cstone_tpu_torch.models import simulation
    from cstone_tpu_torch.parallel import run_ranks
    from cstone_tpu_torch.sfc import PERIODIC, make_box

    xyz, h, v, v_abs = sim_setup(dev)
    domain = Domain(bucket_size=BUCKET, tree_capacity=tree_capacity(N), device=dev)
    box = make_box(0.0, 1.0, boundaries=PERIODIC, device=dev)
    state0 = simulation.sim_init(domain.init_state(box=box, boundaries=(1, 1, 1)), *xyz, h, *v, N)
    ng_max = SIM_NG_MAX
    _, _, _, ovf = simulation.sim_step(domain, state0, SIM_DT, ng_max=ng_max)
    if int(ovf):
        print(f"path I: the cold step overflows with ng_max {ng_max} (JAX's default) at {N} particles; "
              f"ng_max raised to 128 and the cold step run again", flush=True)
        ng_max = 128
    state, energies, moms, step_ms, nb_ms = state0, [], [], [], []
    for step in range(1 + SIM_STEPS):
        with SpanTimer(simulation, "_find_neighbors_impl") as nb:
            (state, e, p, ovf), ms = timed_ms(lambda: simulation.sim_step(domain, state, SIM_DT, ng_max=ng_max))
        check(int(ovf) == 0, f"path I: overflow at step {step}")
        energies.append(float(e))
        moms.append(p.cpu())
        step_ms.append(ms)
        nb_ms.append(nb.ms)
    drift = max(abs(e - energies[1]) for e in energies[1:]) / abs(energies[1])
    p_max = max(float(p.abs().max()) for p in moms)
    diag = simulation.sim_diagnostics(state)
    print(f"path I (a): 1 rank, {N} particles, dt {SIM_DT}, ng_max {ng_max}: cold step and {SIM_STEPS} steps, "
          f"ms/step {json.dumps([round(t, 3) for t in step_ms])}, share in find_neighbors "
          f"{json.dumps([round(a / b, 4) for a, b in zip(nb_ms, step_ms)])}; energy "
          f"{json.dumps(energies)}, drift over steps 1-{SIM_STEPS} {drift:.3e}; largest |momentum| {p_max:.4e} "
          f"(sum |v| {v_abs:.6g}); v_rms {diag['v_rms']:.6f} [{card}]", flush=True)
    check(drift < 2e-2, f"path I: energy drift {drift} over steps 1-{SIM_STEPS}")
    check(p_max < 1e-4 * v_abs, f"path I: |momentum| {p_max} above 1e-4 x sum |v|")
    check(diag["n_local"] == N, f"path I: n_local {diag['n_local']} != {N}")

    # the same positions on LET_RANKS ranks as threads, path F's capacities
    caps = first_caps(tree_cap)
    t0 = time.perf_counter()
    outs = run_ranks(LET_RANKS, sim_rank_steps, *([a] * LET_RANKS for a in (xyz, h, v, box, caps, ng_max)))
    wall_all = 1e3 * (time.perf_counter() - t0)
    e_gap = p_gap = 0.0
    walls = []
    for step in range(1 + SIM_RANK_STEPS):
        per = [o[step] for o in outs]
        check(all(o[2] == 0 for o in per), f"path I, {LET_RANKS} ranks: overflow at step {step}")
        check(sum(o[3] for o in per) == N, f"path I, {LET_RANKS} ranks: n_local sums to {sum(o[3] for o in per)}")
        check(len({o[0] for o in per}) == 1 and all(torch.equal(o[1], per[0][1]) for o in per),
              f"path I, {LET_RANKS} ranks: energy or momentum differ between ranks at step {step}")
        e_gap = max(e_gap, abs(per[0][0] - energies[step]) / abs(energies[step]))
        p_gap = max(p_gap, float((per[0][1] - moms[step]).abs().max()))
        walls.append(1e3 * (max(o[4][1] for o in per) - min(o[4][0] for o in per)))
    print(f"path I (a): {LET_RANKS} ranks as threads (p2p, capacities {caps}): cold step and {SIM_RANK_STEPS} "
          f"steps, {LET_RANKS}-rank step wall ms {json.dumps([round(t, 3) for t in walls])} ({wall_all:.3f} ms in "
          f"all); owned {[o[-1][3] for o in outs]}; energy and momentum equal on every rank; largest gap to the "
          f"one-rank run: energy {e_gap:.3e} of |E| (tolerance 1e-4), momentum {p_gap:.4e} (tolerance 1e-6 x "
          f"sum |v| = {1e-6 * v_abs:.4g}) [{card}]", flush=True)
    check(e_gap <= 1e-4, f"path I: {LET_RANKS}-rank energy {e_gap} of |E| from the one-rank run")
    check(p_gap <= 1e-6 * v_abs, f"path I: {LET_RANKS}-rank momentum {p_gap} from the one-rank run")
    return {"step_ms": step_ms, "nb_ms": nb_ms, "rank_walls": walls, "ng_max": ng_max}


def direct_gravity_sample(x, y, z, m, idx, eps2=1e-8):
    """float64 direct sums over all sources for the targets idx, on the card."""
    import torch

    P = torch.stack([x, y, z], -1).double()
    M = m.double()
    out = []
    for c in range(0, idx.numel(), 32):
        t = idx[c:c + 32]
        d = P[None, :, :] - P[t][:, None, :]
        r2 = (d * d).sum(-1) + eps2
        w = torch.where(torch.arange(P.shape[0], device=P.device)[None, :] == t[:, None], 0.0, M * r2 ** -1.5)
        out.append((w[..., None] * d).sum(1))
    return torch.cat(out)


def gravity_phase(dev, card):
    """Phase 13 (b): Domain.sync(grav=True) + update_expansion_centers +
    gravity_monopole at 1M Gaussian, against float64 direct sums."""
    import torch

    from cstone_tpu_torch.domain import Domain, sync_with_retry
    from cstone_tpu_torch.models import nbody
    from cstone_tpu_torch.sfc import make_box
    from cstone_tpu_torch.traversal.geometry import node_geometry

    rng = np.random.RandomState(SEED)
    pos = rng.normal(0, 0.25, size=(N, 3)).clip(-0.99, 0.99).astype(np.float32)
    m = torch.from_numpy(rng.uniform(0.5, 1.5, size=N).astype(np.float32)).to(dev)
    xyz = tuple(torch.from_numpy(np.ascontiguousarray(pos[:, i])).to(dev) for i in range(3))
    h = torch.full((N,), H, dtype=torch.float32, device=dev)
    box = make_box(-1.0, 1.0, device=dev)

    def run(caps):
        domain = Domain(bucket_size=BUCKET, theta=GRAV_THETA, tree_capacity=caps["tree"], device=dev)
        state, res = domain.sync(domain.init_state(box=box), *xyz, h, properties=(m,), grav=True)
        return domain, state, res

    ((domain, state, res), caps), sync_ms = timed_ms(lambda: sync_with_retry(run, {"tree": tree_capacity(N)}))
    (centers, spheres, _, c_ovf), cent_ms = timed_ms(
        lambda: domain.update_expansion_centers(state, res, res.properties[0]))
    check(int(res.overflow) == 0 and int(c_ovf) == 0, "path I (b): sync or expansion-centre overflow")
    geo_c, geo_s = node_geometry(res.tree, state.box)
    ms_ = res.properties[0]

    def gravity(leaf_cap, cand_cap):
        return nbody.gravity_monopole(res.x, res.y, res.z, ms_, res.tree, res.layout, centers, spheres[:, 3],
                                      geo_c, geo_s, state.box, leaf_cap=leaf_cap, cand_cap=cand_cap, n_targets=N)

    leaf_cap, cand_cap = 4096, 4096
    *_, ovf0 = gravity(leaf_cap, cand_cap)
    first = int(ovf0)
    check(first == 0 or first > cand_cap, f"path I (b): P2P leaves overflow leaf_cap {leaf_cap}: {first}")
    if first:
        cand_cap = -(-first // 1024) * 1024
    with SpanTimer(nbody, "batched_collect_leaves") as walk, SpanTimer(nbody, "_monopoles") as mono, \
            SpanTimer(nbody, "_p2p_sums") as p2p:
        (ax, ay, az, ovf), call_ms = timed_ms(lambda: gravity(leaf_cap, cand_cap))
    check(int(ovf) == 0, f"path I (b): gravity overflow {int(ovf)} with leaf_cap {leaf_cap}, cand_cap {cand_cap}")
    idx = torch.from_numpy(np.random.RandomState(SEED + 1).choice(N, GRAV_SAMPLE, replace=False)).to(dev)
    ref = direct_gravity_sample(res.x[:N], res.y[:N], res.z[:N], ms_[:N], idx)
    a = torch.stack([ax, ay, az], -1)[idx].double()
    err = ((a - ref).norm(dim=1) / ref.norm(dim=1)).cpu().numpy()
    med, p95 = float(np.median(err)), float(np.percentile(err, 95))
    print(f"path I (b): gravity, {N} Gaussian particles, theta {GRAV_THETA}, bucket {BUCKET}, groups of 64: "
          f"sync(grav=True) {sync_ms:.3f} ms (tree capacity {caps['tree']}, focus leaves {int(res.tree.n_leaf)}), "
          f"update_expansion_centers {cent_ms:.3f} ms; first call's overflow {first} -> leaf_cap {leaf_cap}, "
          f"cand_cap {cand_cap}; gravity_monopole {call_ms:.3f} ms: P2P leaf walk {walk.ms:.3f}, monopole walk "
          f"{mono.ms:.3f}, P2P sums {p2p.ms:.3f} ms; against float64 direct sums on {GRAV_SAMPLE} targets: "
          f"median relative error {med:.4e}, 95th percentile {p95:.4e} [{card}]", flush=True)
    check(bool(torch.isfinite(torch.stack([ax, ay, az])).all()), "path I (b): non-finite accelerations")
    check(med < 2e-2 and p95 < 0.2, f"path I (b): gravity error median {med}, p95 {p95}")
    return {"call_ms": call_ms, "walk_ms": walk.ms, "mono_ms": mono.ms, "p2p_ms": p2p.ms, "median": med,
            "p95": p95, "leaf_cap": leaf_cap, "cand_cap": cand_cap}


# ----------------------------------------------------------------------------
# phase 14: path J, the dense p2p protocol over a peer window
# ----------------------------------------------------------------------------

WINDOW_TRIES = 4


def window_cold_step(comm, setup, caps, window):
    """Path J's cold step on one rank: a p2p Domain, dense protocol, over a
    peer window of `window` ranks, at path F's inputs and capacities, one
    sync. Returns (state, res, span, input, domain, the comm's RankTally,
    reset before the sync)."""
    tally = RankTally.of(comm)
    tally.reset()
    domain = make_domain(comm, caps, "p2p", "dense", setup["ids"].device, window)
    state = domain.init_state(box=setup["box"], boundaries=(1, 1, 1))
    inp = rank_input(setup, comm.rank, caps["local"])
    state, res, span = rank_sync(comm, domain, state, inp)
    return state, res, span, inp, domain, tally


def window_need_of(domain, state, res) -> int:
    """What overflow_detail[6] must say for one rank: the largest rank
    offset of its halo leaves' owners and of its MAC peers (diagnostics'
    mac_peer_max_offset), where that exceeds the window; else 0."""
    import torch

    from cstone_tpu_torch.ops.primitives import searchsorted

    n_leaf = int(res.tree.n_leaf)
    owner = torch.clamp(searchsorted(state.assignment.boundaries, res.tree.leaves[:n_leaf], side="right") - 1,
                        0, domain.n_ranks - 1)
    halo = res.halo_flags[:n_leaf].bool()
    off = int((owner[halo] - domain.rank).abs().max()) if bool(halo.any()) else 0
    need = max(off, domain.diagnostics(state, res)["mac_peer_max_offset"])
    return need if need > domain.peer_window else 0


def window_lines(what, window, results, spans, stats, peers_ms, path_f, step, card) -> None:
    """Print one path-J sync's window, overflow, rounds, bytes and walls
    beside path F's at the same step."""
    wall = 1e3 * (max(e for _, e in spans) - min(s for s, _ in spans))
    per_rank = [1e3 * (e - s) for s, e in spans]
    detail = results[0].overflow_detail.tolist()
    peers = [round(peers_ms.get(f"rank-{r}", 0.0), 3) for r in range(len(results))]
    print(f"{what}: W {window}, win_need {detail[6]}, overflow_detail {detail}; {len(results)}-rank sync wall "
          f"{wall:.3f} ms (path F {path_f['walls'][step]:.3f}); per rank sync ms "
          f"{json.dumps([round(t, 3) for t in per_rank])}, of it find_peers_mac ms {json.dumps(peers)} [{card}]",
          flush=True)
    print(f"{what}: per rank ppermute rounds {json.dumps([x['ppermute'] for x in stats])}, bytes sent "
          f"{json.dumps([x['ppermute_bytes'] for x in stats])}; all_to_all rounds "
          f"{json.dumps([x['all_to_all'] for x in stats])}, bytes {json.dumps([x['all_to_all_bytes'] for x in stats])}"
          f" (path F: all_to_all rounds {json.dumps(path_f['rounds'][step])}, bytes "
          f"{json.dumps(path_f['bytes'][step])})", flush=True)


def path_j_rank(comm, tree_cap, window):
    """One rank process of path J (b) (run by parallel.dist.spawn_ranks):
    the cold step at the window path J (a) converged to, then B1 and B2 on
    the rank's buffer, each launch held to its plain version here."""
    from cstone_tpu_torch.ops import neighbors_v1, neighbors_v2, stencil
    from cstone_tpu_torch.ops.cuda_lib import record_launches

    libs = (stencil.SYM_LIBRARY, stencil.LIBRARY, neighbors_v2.LIBRARY, neighbors_v1.LIBRARY)
    for lib in libs:
        lib.load()  # the libraries phase 2 built: loaded, never built here
    setup = ranks_setup(comm.device)
    reset_all_launches()
    state, res, span, inp, domain, tally = window_cold_step(comm, setup, first_caps(tree_cap), window)
    stats = tally.read()
    with record_launches() as calls:
        after = rank_after(comm, domain, state, res, inp)
    launches = all_launches()
    err = Errors()
    hold_to_plain(err, calls, f"path-J (b) inputs, rank {comm.rank}")
    return {"built": [lib.source.name for lib in libs if lib.build_log], "rec": rank_record(state, res, after, span,
                                                                                          stats),
            "rows": (res.halo_record.window, res.halo_record.send_idx.shape[0]), "launches": launches,
            "launched": sorted(c[0] for c in calls), "err": err.max}


def window_phase(dev, card, reference, tree_cap, path_f):
    """Phase 14, path J: (a) LET_RANKS ranks as threads (run_ranks) of the
    p2p Domain with the dense protocol over a peer window, path F's inputs
    and capacities; the cold step grows the window from 1 by
    overflow_detail[6], then POOL_DRIFT_STEPS drift steps at the converged
    window, B1 and B2 on every rank's buffer after each sync; checked
    against phase 4 and path F at every step. (b) the converged window's
    cold step on LET_RANKS rank processes over gloo, equal to (a). Returns
    (launches of (a) and (b), Errors)."""
    import torch

    from cstone_tpu_torch.domain import domain as domain_module
    from cstone_tpu_torch.ops.cuda_lib import record_launches
    from cstone_tpu_torch.parallel import run_ranks
    from cstone_tpu_torch.parallel.dist import spawn_ranks

    R = LET_RANKS
    setup = ranks_setup(dev)
    caps = first_caps(tree_cap)
    t_start = time.perf_counter()

    # (a) the cold step, the window grown from 1
    reset_all_launches()
    window, tries = 1, []
    for _ in range(WINDOW_TRIES):
        with RankTimer(domain_module, "find_peers_mac") as peers:
            outs = run_ranks(R, lambda comm: window_cold_step(comm, setup, caps, window))
        states, results, spans, inputs, domains, tallies = ([o[i] for o in outs] for i in range(6))
        detail = results[0].overflow_detail.tolist()
        tries.append((window, detail))
        for r, res in enumerate(results):
            rec = res.halo_record
            check(rec.window == window and rec.send_idx.shape[0] == 2 * window + 1,
                  f"path J, W={window}, rank {r}: a halo record of window {rec.window}, {rec.send_idx.shape[0]} rows")
            check(torch.equal(res.overflow_detail, results[0].overflow_detail), "the ranks report different overflows")
        want = max(window_need_of(d, st, res) for d, st, res in zip(domains, states, results))
        check(detail[6] == want, f"path J, W={window}: overflow_detail[6] is {detail[6]}, the halo owners and "
              f"MAC peers need {want}")
        window_lines(f"path J, cold step, try {len(tries)}", window, results, spans, [t.read() for t in tallies],
                     peers.ms, path_f, 0, card)
        if int(results[0].overflow) == 0:
            break
        check(detail[6] > window, f"path J: an overflow without a window report: {tries}")
        window = detail[6]
    else:
        raise RuntimeError(f"chip_smoke check failed: path J's window never converged: {tries}")
    print(f"path J: the window grew {' -> '.join(str(w) for w, _ in tries)} in {len(tries)} cold syncs; halo "
          f"records of 2W+1 rows at every try [{card}]", flush=True)

    # (a) the drift steps at the converged window
    err = Errors()
    box = setup["box"]
    record, sgn = [], 1.0
    for step in range(1 + POOL_DRIFT_STEPS):
        what = f"path J, W={window}, " + ("cold step" if step == 0 else f"drift step {step}")
        if step > 0:
            inputs = [drift_input(inp, setup["drift"], sgn) for inp in inputs]
            sgn = -sgn
            for t in tallies:
                t.reset()
            with RankTimer(domain_module, "find_peers_mac") as peers:
                outs = run_ranks(R, rank_sync, domains, states, inputs)
            states, results, spans = ([o[i] for o in outs] for i in range(3))
            window_lines(what, window, results, spans, [t.read() for t in tallies], peers.ms, path_f, step, card)
        with record_launches() as calls:
            after = run_ranks(R, rank_after, domains, states, results, inputs)
        pool_checks(what, reference[step], states, results, after, box, False, card)
        record.append(path_record(states, results, after))
        same_as_path_e(what, path_f["record"][step], record[step], "path F")
        inputs = [a["next"] for a in after]
    launches = all_launches()
    for k in ("stencil_counts", "stencil_density"):
        check(launches[k] == R * (1 + POOL_DRIFT_STEPS), f"{k} should launch once per rank and step: {launches}")
    names = sorted(c[0] for c in calls)
    check(names == ["stencil_counts"] * R + ["stencil_density"] * R, f"path J's last step launched {names}")
    hold_to_plain(err, calls, "path-J inputs")
    print(f"path J (a): {R} thread ranks, {1e3 * (time.perf_counter() - t_start):.3f} ms; launches "
          f"{json.dumps(launches)}; the last step's {len(calls)} B1/B2 launches equal their plain versions [{card}]",
          flush=True)

    # (b) the converged window's cold step on rank processes
    t0 = time.perf_counter()
    outs = spawn_ranks(R, path_j_rank, [tree_cap] * R, [window] * R, backend="gloo", device=dev, timeout=600.0,
                       deadline=600.0)
    print(f"path J (b): {R} rank processes over gloo, the cold step at W={window}, "
          f"{1e3 * (time.perf_counter() - t0):.3f} ms with the processes' start [{card}]", flush=True)
    check(all(not o["built"] for o in outs), f"a rank process built a kernel: {[o['built'] for o in outs]}")
    recs = [o["rec"] for o in outs]
    check(all(o["rows"] == (window, 2 * window + 1) for o in outs), f"path J (b): halo records {[o['rows'] for o in outs]}")
    check(all(rec["overflow_detail"] == tries[-1][1] for rec in recs), "path J (b): the overflow differs from (a)'s")
    what = f"path J (b), W={window}, cold step"
    spans = [rec["span"] for rec in recs]
    c = [rec["comm"] for rec in recs]
    print(f"{what}: {R}-process sync wall {1e3 * (max(e for _, e in spans) - min(s for s, _ in spans)):.3f} ms; per "
          f"rank ppermute rounds {json.dumps([x['ppermute'] for x in c])}, bytes sent "
          f"{json.dumps([x['ppermute_bytes'] for x in c])}; all_to_all rounds {json.dumps([x['all_to_all'] for x in c])}; "
          f"staged through host memory {json.dumps([x['staged_bytes'] for x in c])} [{card}]", flush=True)
    pool_checks(what, reference[0], *rank_views(recs), None, False, card)
    same_as_path_e(what, record[0], [{k: rec[k] for k in ("boundaries", "leaves", "halo_flags", "layout",
                                                           "n_with_halos", "halo_ids")} for rec in recs],
                   "path J (a)")
    for k in ("stencil_counts", "stencil_density"):
        check(all(o["launches"][k] == 1 for o in outs), f"path J (b): {k} should launch once in every rank")
        launches[k] += sum(o["launches"][k] for o in outs)
    check(all(o["launched"] == ["stencil_counts", "stencil_density"] for o in outs), "path J (b): launches")
    for o in outs:
        for k, v in o["err"].items():
            err.max[k] = max(err.max[k], v)
    print(f"path J launches, threads and processes: {json.dumps(launches)}; phase 14 took "
          f"{time.perf_counter() - t_start:.3f} s [{card}]", flush=True)
    return launches, err


def same_as_path_e(what, want, got, ref="path E") -> None:
    """A path against path E (or `ref`) at the same step: per rank the
    assignment, the focus tree's leaves, the halo flags, the layout and
    the buffer size are equal, and exchange_halos of the particle ids puts
    into every slot the id the reference's slot holds."""
    import torch

    for r, (e, f) in enumerate(zip(want, got)):
        for k in ("boundaries", "leaves", "halo_flags", "layout"):
            check(e[k].shape == f[k].shape and torch.equal(e[k], f[k]), f"{what}, rank {r}: {k} differs from {ref}'s")
        check(e["n_with_halos"] == f["n_with_halos"], f"{what}, rank {r}: n_with_halos differs from {ref}'s")
        check(torch.equal(e["halo_ids"], f["halo_ids"]),
              f"{what}, rank {r}: exchange_halos put other ids than {ref}'s into "
              f"{int((e['halo_ids'] != f['halo_ids']).sum())} slots")
    print(f"{what}: assignment, focus leaves, halo flags, layout, buffer size and the halo slots' ids of every "
          f"rank equal {ref}'s", flush=True)


def pool_checks(what, ref, states, results, after, box, pool, card) -> None:
    """Path E or F against phase 4's single-rank run on the same positions.
    pool: reapply_sync filled the halo slots too (pool mode), so
    exchange_halos must put the same ids there; and on the cold step rank
    LET_RANK's halo flags are held against all box pairs."""
    import torch

    from cstone_tpu_torch.ops.keys64 import ule, ult
    from cstone_tpu_torch.ops.primitives import searchsorted, segment_max

    R = len(results)
    dev = results[0].keys.device
    counts = torch.full((N,), -1, dtype=torch.int32, device=dev)
    rho = torch.zeros(N, dtype=torch.float32, device=dev)
    owned_ids = []
    ref_keys, ref_counts = ref["tree"]
    for r, (state, res, a) in enumerate(zip(states, results, after)):
        check(int(res.overflow) == 0 and not a["cell_ovf"], f"{what}, rank {r}: overflow "
              f"{res.overflow_detail.tolist()}, cell overflow {a['cell_ovf']}")
        t = state.global_tree
        nn = int(t.n_nodes)
        check(nn + 1 == ref_keys.numel() and torch.equal(t.keys[:nn + 1], ref_keys)
              and torch.equal(t.counts[:nn], ref_counts), f"{what}, rank {r}: the global tree is not phase 4's")
        s, e, nwh = int(res.start_index), int(res.end_index), int(res.n_with_halos)
        bnd = state.assignment.boundaries
        keys = res.keys[s:e]
        check(bool((ule(bnd[r], keys) & ult(keys, bnd[r + 1])).all()),
              f"{what}, rank {r}: an owned key lies outside the rank's range")
        rid, hid = a["rid"], a["halo_ids"]
        check(bool((hid[:nwh] >= 0).all()) and torch.equal(hid[s:e], rid[s:e])
              and (not pool or torch.equal(hid[:nwh], rid[:nwh])),
              f"{what}, rank {r}: exchange_halos did not put the owners' ids into the halo slots")
        owned_ids.append(rid[s:e])
        counts[rid[s:e]] = a["counts"][s:e]
        rho[rid[s:e]] = a["rho"][s:e]
    ids = torch.cat(owned_ids)
    check(ids.numel() == N and torch.equal(torch.sort(ids).values, torch.arange(N, device=dev)),
          f"{what}: the owned ranges are not a partition of the {N} particles")
    check(torch.equal(counts, ref["counts"]), f"{what}: B1 counts differ from phase 4's at "
          f"{int((counts != ref['counts']).sum())} particles")
    ok = torch.allclose(rho, ref["rho"], rtol=1e-5, atol=0.0)
    check(ok, f"{what}: B2 densities differ from phase 4's beyond rtol 1e-5 "
          f"(max rel {float(((rho - ref['rho']).abs() / ref['rho']).max())})")
    gap = (rho - ref["rho"]).abs()
    print(f"{what}: densities against phase 4's, B2 on another buffer: max abs gap {float(gap.max())}, "
          f"max rel gap {float((gap / ref['rho']).max())} [{card}]", flush=True)
    sizes = [int(res.end_index) - int(res.start_index) for res in results]
    halos = [int(res.n_with_halos) - n for res, n in zip(results, sizes)]
    print(f"{what}: global trees equal phase 4's; owned {sizes} (sum {sum(sizes)}), halo particles {halos}; "
          f"B1 counts by particle bit-equal to phase 4's, B2 densities within rtol 1e-5", flush=True)
    if pool and what.endswith("cold step"):
        r = LET_RANK
        state, res = states[r], results[r]
        leaves = res.tree.leaves
        cap_leaf = leaves.shape[0] - 1
        lif = torch.arange(cap_leaf, device=dev)
        first, last = searchsorted(leaves, state.assignment.boundaries[r:r + 2])
        mine = (lif >= first) & (lif < last)
        # the radius of an own leaf: 2 x max h over its particles, all of
        # them in the rank's buffer (an empty leaf's max is -inf)
        j = torch.arange(res.h.shape[0], device=dev)
        hmax = segment_max(torch.where(j < res.n_with_halos, res.h, -float("inf")), res.layout, cap_leaf)
        radii = torch.where(mine, torch.clamp(hmax, min=0.0) * 2.0, 0.0)
        halo_flags_ok(leaves, res.tree.n_leaf, radii, state.box, mine, res.halo_flags, f"{what}, rank {r}")


def halo_flags_ok(leaves, n_leaf, radii, box, mine, halo_flags, what) -> None:
    """Check one rank's halo flags against all pairs of (own leaf's halo
    box, foreign leaf box): a foreign leaf is a halo exactly when its box
    overlaps the box of one of the rank's own leaves extended by that
    leaf's radius."""
    import torch

    from cstone_tpu_torch.sfc.box import IBox
    from cstone_tpu_torch.sfc.encode import sfc_ibox
    from cstone_tpu_torch.sfc.keys import node_range, tree_level
    from cstone_tpu_torch.traversal.boxoverlap import make_halo_box, overlap_iboxes

    kdt, dev = leaves.dtype, leaves.device
    fields = ("xmin", "xmax", "ymin", "ymax", "zmin", "zmax")
    cap_leaf = leaves.shape[0] - 1
    lif = torch.arange(cap_leaf, device=dev)
    key = leaves[:-1]
    rng = leaves[1:] - key
    level = tree_level(torch.where(rng != 0, rng, node_range(kdt, 21)))
    ibox = sfc_ibox(key, level)
    hbox = make_halo_box(ibox, radii, box, kdt)
    own, foreign = torch.nonzero(mine)[:, 0], torch.nonzero((lif < n_leaf) & ~mine)[:, 0]
    src = IBox(*(getattr(ibox, f)[foreign][None, :] for f in fields))
    want = torch.zeros(cap_leaf, dtype=torch.int32, device=dev)
    for c in range(0, own.numel(), 512):
        tgt = IBox(*(getattr(hbox, f)[own[c:c + 512]][:, None] for f in fields))
        want[foreign] |= overlap_iboxes(src, tgt, kdt).any(dim=0).to(torch.int32)
    check(int(halo_flags[mine].sum()) == 0, f"{what}: a leaf of the rank's own range is flagged as halo")
    check(torch.equal(halo_flags, want), f"{what}: halo flags differ from all pairs at "
          f"{int((halo_flags != want).sum())} of {int(n_leaf)} leaves")
    check(0 < int(want.sum()) < foreign.numel(), f"{what}: the halo set should be a proper part of the foreign leaves")
    print(f"{what}: halo flags equal all {own.numel()} x {foreign.numel()} box pairs", flush=True)


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
        pairs = run_pairs(r2, run_len)
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
    launches, err4, timing, (reference, tree_cap) = main_path_phase(dev, card)

    phase("5 path A: sync + tiered adaptive-h counts")
    launches5, err5, times5 = tiered_phase(dev, card)
    launches.update(launches5)
    timing.update(times5)

    phase("6 path B: sync + ns_view + find_neighbors")
    launches6, err6, times6, phase6 = find_neighbors_phase(dev, card)
    launches.update(launches6)
    timing.update(times6)

    phase("7 path C: sync with a focus tree of its own + counts")
    launches_c, err7, res_c, state_c = focus_tree_phase(dev, card)

    phase("8 path D: one rank's locally essential tree and halos from the pool")
    let_phase(dev, card, res_c, state_c)
    del res_c, state_c

    phase("9 path E: 8 ranks in pool mode on the card + cell-list counts and density")
    launches_e, err9, path_e = ranks_phase(dev, card, reference, tree_cap, "pool")

    phase("10 path F: 8 ranks in p2p mode on the card + cell-list counts and density")
    launches_f, err10, path_f = ranks_phase(dev, card, reference, tree_cap, "p2p", path_e)
    del path_e

    phase("11 path G: 8 rank processes on the card, dense and ragged p2p + cell-list counts and density")
    launches_g, err11 = processes_phase(dev, card, reference, tree_cap, path_f)

    phase("12 path H: bench.py fn mode's grid cover and depth-first walk feeding B5")
    launches_h, err12, _ = fn_feeds_phase(dev, card, phase6)
    del phase6

    phase("13 path I: the simulation loop and Barnes-Hut gravity")
    simulation_phase(dev, card, tree_cap)
    gravity_phase(dev, card)

    phase("14 path J: 8 ranks of the dense p2p protocol over a peer window, threads then processes")
    launches_j, err14 = window_phase(dev, card, reference, tree_cap, path_f)
    del path_f

    for e in (err4, err5, err6, err7, err9, err10, err11, err12, err14):
        for k, v in e.max.items():
            err.max[k] = max(err.max[k], v)
    print(f"total time {time.perf_counter() - t_start:.3f} s [{card}]", flush=True)
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep, "launches": launches[name],
         "max_abs_err": err.max[name], "library_ms": None, "path_c_launches": launches_c.get(name, 0),
         "path_e_launches": launches_e.get(name, 0), "path_f_launches": launches_f.get(name, 0),
         "path_g_launches": launches_g.get(name, 0), "path_h_launches": launches_h.get(name, 0),
         "path_j_launches": launches_j.get(name, 0), **timing[name]}
        for name, (src, rep) in KERNELS.items()
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
