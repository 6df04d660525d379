#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (cstone_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure raises and exits non-zero:
  1. card: nvidia-smi name and power limit, torch's device name; refuses
     to run without CUDA (there is no CPU fallback);
  2. build: compiles every registered kernel source (cuda_lib.libraries():
     csrc/mark_macs.cu, neighbors_v1.cu, neighbors_v2.cu, sfc.cu,
     stencil_sym.cu) with nvcc, one process each, all started together,
     and prints ptxas' registers, shared memory and spills per kernel;
  3. kernel vs plain version on the card: B1/B2 (the half-stencil kernel)
     at levels 3 and 5, cap 64, periodic and open, uniform and Gaussian,
     B1 launched twice (the same counts each launch); B1 on a pair across
     each periodic edge whose d2 differs between its ends; B1/B2 at level 2 with caps
     1088 and 2496 (densest cell above 1024); B3 (one symmetric launch for
     both sides) at levels 2 and 3 with unequal caps, its lanes on each
     table in turn, one lane-table cap above 1024, periodic and open,
     count and density with masses, and on the wrap pair split across the
     two tables; B4 against impl="xla" and against its plain version on
     rows of 0/1/32/33/64 valid slots at levels 2-5 (cell_rows), periodic
     and open, at caps 1088 and 2496 and on the wrap pairs; B6 on groups of
     1, 33, 256 and 1024 over 300 and 4133 candidates with holes, an empty
     group, self indices at tile edges and r2 < 0 (dense_groups); B5 and B6 on the arguments
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
     launched; on the last step's inputs checks B4 (the one-sided mode of
     csrc/stencil_sym.cu) equal to B1 and times B1, B2 and B4 alone and
     their plain versions, with each kernel's bound (B4: B1's function
     bound and the one-sided work bound, every ordered pair tested);
  5. path A, the tiered adaptive-h cell list: 1M Gaussian particles (seed
     42) in the periodic unit box, h = adaptive_h(pos, 100 neighbours),
     bucket 64, tiers from choose_tier_levels(max_tiers=3) and tier_caps
     (slack 1.3). Domain.sync + cell_list_neighbor_counts_tiered for 1
     warm and 3 drift steps; checks overflow 0, at least 2 tiers, B1
     launched and B3 launched once per tier pair and step, every B1 and B3
     launch of the last step bit-equal to its plain version on the
     arguments it was given and timed on them in device time, and the tiered counts
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
     marked node wholly inside the focus, and its walk's kernel
     (csrc/mark_macs.cu, one launch a call) equal to the plain walk on the
     card. Prints the converge iterations, batched_mark's levels per call
     and the ms of the whole build, then the kernel's launches and ms, the
     plain walk's ms and tests, and their bound;
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
     Each process runs (a) and then (b), (b) through multichip.rank_steps,
     the rank body of the steps mode that runs one card a rank over NCCL. (a) the dry run of
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
     monopole walk and P2P sums. Path I launches none of B1-B6; its
     syncs encode their keys through K1.
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
     W's cold step on LET_RANKS rank processes over gloo (spawn_ranks,
     each running multichip.rank_steps), equal to (a)'s, B1/B2 once in
     each, held to plain there.
 15. path L, the octree build of bench.py's tree mode (bench.py:423-517,
     the reference's test/performance/octree.cpp:107-136), driven by
     cstone_tpu_torch/octree_build.py: bench.py's Gaussian sample
     normal(0.5, 0.15) clipped to [0, 1 - 1e-6] (seed 42) in the
     periodic unit box, bucket 16, at 2M uint64 Hilbert
     (octree_build_2M), 64M uint64 Hilbert (octree_build_64M), 2M uint64
     Morton (octree.cu:70-115) and 2M uint32 Hilbert: compute_sfc_keys and
     the unsigned sort, compute_octree from bench.py's capacity and warm
     start (regrown once as bench.py regrows it), update_octree against
     the drifted keys until it converges. Checks the cornerstone
     invariants at the key width, the unique fixed point, the build and
     the converged update bit-equal to the host C++ oracle
     (native.compute_octree_host) of the same sorted keys, the 2M Hilbert
     keys equal to native.hilbert_encode's. Prints the iterations, the
     node counts, the medians and quartiles of OCTREE_REPS builds, single
     update steps and updates to convergence (CUDA events, each ending on
     a host read), keys/s, the peak memory and the oracle's seconds. On
     the 2M uint64 Hilbert tree, the leaf modules no other path calls,
     each bit-equal to the same call on the CPU: compute_spanning_tree,
     build_binary_tree, compute_continuum_csarray, stencil_stats;
 16. path M, syncGrav on LET_RANKS thread ranks, driven by
     cstone_tpu_torch/grav_ranks.py: path I (b)'s particles, strided over
     the ranks, a cold Domain.sync(grav=True) under sync_with_retry from
     path F's capacities and a drift step, each followed by
     update_expansion_centers, in pool then p2p mode, and the same steps
     at one rank. Checks overflow 0, the owned ids a partition of the
     particles, p2p equal to pool on every rank (assignment, focus
     leaves, layout, halo flags over the leaves, keys), the one-rank
     centres within rtol 1e-5 of the float64 centre of mass of every
     node; on the focus nodes in a rank's own assignment its centres and
     MAC spheres within rtol 1e-5 of the one-rank run's; on every other
     node its centres within 16 rounding units of the float64 centre of
     mass (the bound the owners' float32 prefix sums put on a range sum)
     and its MAC radii moved no more than their centres; plain float32
     prefix sums of the same leaves under that limit and a 16-bit
     control above it. Prints each rank's sync ms, all_to_all rounds and
     bytes and the 8-rank wall. Then Halos (one rank),
     exchange_focus_quantities (8 ranks), ParticleFields and a
     checkpoint round trip of a DomainState on the card, each equal
     to the same call on the CPU. Paths L and M launch none of B1-B6
     (checked); their keys go through K1 (sfc_encode > 0, checked).
 17. path N, cstone_tpu_torch.multichip's grav steps mode (the per-rank
     body of `multichip --steps --grav`, which runs one rank a card over
     NCCL on four cards) on GRAV_PROC_RANKS (4) rank processes that
     share the one card over gloo (parallel.dist.spawn_ranks; NCCL
     refuses two ranks on one card), so that DistComm's all_to_all,
     ragged_all_to_all and ppermute carry gravity's range sums: path M's
     N particles, N / 4 a rank, a cold step under sync_with_retry from
     multichip.first_caps and GRAV_DRIFT_STEPS drift steps, each followed
     by update_expansion_centers, in pool, dense, ragged and window
     (grown from 1 to 3 by overflow_detail[6]) mode. Each rank process
     first runs the one-card run of the same particles on the card, then
     holds its own every step (grav_ranks.rank_checks): overflow 0, the
     owned ids a partition (one all_reduce), its own nodes within rtol
     1e-5 of the one-card run, every other node within 16 rounding units
     of the float64 centre of mass, the p2p modes equal to pool slot for
     slot. Prints the 4-process sync wall, per-rank sync and centres ms,
     rounds and bytes, halo particles and the readings. Like path M it
     launches none of B1-B6 (the JAX package's syncGrav path calls none):
     every rank's counts of them must be 0, its K1 encodes above 0.
 18. the Hilbert key codec (csrc/sfc.cu, K1) at the main path's shapes:
     CODEC_N uniform float32 particles in the periodic unit box encoded
     to uint64 keys (compute_sfc_keys, as Domain.sync's sync.keys does),
     and those keys decoded (decode_sfc); K1's integer encode as its
     callers launch it (sfc_grid_checks): isfc_key on int64 coordinates
     in and around the grid, as the extended and halo boxes of
     macs.prepare_marks and collisions.find_halos give, contained_in_keys
     on CONTAIN_N extended node boxes, isfc_key_top at every level count
     cover.py may ask for. Checks each result bit-equal to the plain
     codec (encode._grid_coords and sfc/hilbert.py) run on the card, or
     to the same call on the CPU, and one launch a call. Prints each
     kernel's ms (device time of
     CODEC_REPS queued calls, device_time_ms), its bound (bytes over 3.35
     TB/s), the integer operations as the source writes them and their
     time at INT32_PEAK, and the plain codec's ms (one warm call).
Each path's launch counts (B1-B6 and K1's sfc_encode, sfc_decode) are set to 0 just before it is driven and read
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

from cstone_tpu_torch.multichip import tree_capacity
from cstone_tpu_torch.ops.cuda_lib import all_launches, libraries, plain_of, reset_all_launches

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

SYM_SRC = "cstone_tpu_torch/csrc/stencil_sym.cu"
KERNELS = {  # name: (source, TPU kernel it replaces)
    "stencil_counts": (SYM_SRC, "cstone_tpu/ops/pallas_stencil.py:295"),
    "stencil_density": (SYM_SRC, "cstone_tpu/ops/pallas_stencil.py:295"),
    "stencil_cross": (SYM_SRC, "cstone_tpu/ops/pallas_stencil.py:589"),
    "stencil_counts_asym": (SYM_SRC, "cstone_tpu/ops/pallas_stencil.py:149"),
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
# 32-bit integer operations: 64 lanes an SM (four partitions of 16), 132
# SMs at the 1.98 GHz boost clock (the Hopper white paper's SM)
INT32_PEAK = 132 * 64 * 1.98e9
# phase 18: the codec at the main path's 2M particles. Integer operations a
# round as the source writes them (bit extracts, octant and digit, the
# key's shift-add, reflection masks and xors, rotate-or-swap selects): the
# compiler fuses three-input logic into one instruction, so their time at
# INT32_PEAK is printed beside the bound, not taken as one
CODEC_N = 2_000_000
CONTAIN_N = 299_593  # the nodes of a rank's tree in the 4-card cell: the boxes macs.prepare_marks tests
CODEC_REPS = 20
OPS_ENCODE_ROUND, OPS_DECODE_ROUND = 39, 48
# FP32 operations of one MAC test of mark_macs's walk: the minimum image,
# the clamp, the squared norm and the compare
MAC_OPS = 25
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


def no_cell_list_kernel(launches: dict, what: str) -> None:
    """A path that launches none of B1-B6 and encodes its keys through K1."""
    launched = {k: launches[k] for k in KERNELS if launches[k]}
    check(not launched, f"{what} launched {launched}")
    check(launches["sfc_encode"] > 0, f"{what} encoded no keys through K1: {launches}")


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
    packed, valid, _, ovf = celllist.ell_pack_gather(keys, perm, fields, cap, level, n_valid=n_valid)
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

    from cstone_tpu_torch.ops.keys64 import usort
    from cstone_tpu_torch.sfc import compute_sfc_keys, make_box

    from cstone_tpu_torch.ops import neighbors_v1, neighbors_v2, stencil
    from cstone_tpu_torch.ops.cuda_lib import record_launches
    from cstone_tpu_torch.traversal import neighbors
    from cstone_tpu_torch.utils.workloads import (
        cell_rows,
        dense_groups,
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
        what = f"wrap pair on axis {axis}, d2 {d2_i!r} / {d2_j!r}"
        err.counts("stencil_counts", stencil.stencil_counts(px, py, pz, r2, valid, L, (True,) * 3, level),
                   want, what)
        err.counts("stencil_counts_asym",
                   stencil.stencil_counts_asym(px, py, pz, r2, valid, L, (True,) * 3, level),
                   stencil.stencil_counts_asym_plain(px, py, pz, r2, valid, L, (True,) * 3, level), what)
    print("B1/B4 vs plain: pairs across the periodic wrap with end-dependent d2: ok", flush=True)

    # B4 on rows of 0, 1, 32, 33 and 64 valid slots (before, at and past a
    # 32-slot chunk edge), levels 2-5, periodic and open
    for level in (2, 3, 4, 5):
        pos, h = cell_rows(level, seed=level)
        for periodic in (True, False):
            box = make_box(0.0, 1.0, boundaries=int(periodic), device=dev)
            p = torch.from_numpy(pos).to(dev)
            keys, order = usort(compute_sfc_keys(p[:, 0], p[:, 1], p[:, 2], box, np.uint64))
            cols = (p[:, 0], p[:, 1], p[:, 2], torch.from_numpy(h).to(dev))
            px, py, pz, _, r2, _, valid = ell_inputs(keys, *(c[order].contiguous() for c in cols),
                                                     box, level, CAP)
            lengths = sorted(set(valid.sum(dim=1).tolist()))
            check(lengths == [0, 1, 32, 33, 64], f"rows of {lengths} slots")
            args = (px, py, pz, r2, valid, box.lengths, flags_of(box), level)
            what = f"level {level}, {pos.shape[0]} particles in rows of {lengths} slots, periodic {periodic}"
            err.counts("stencil_counts_asym", stencil.stencil_counts_asym(*args),
                       stencil.stencil_counts_asym_plain(*args), what)
            print(f"B4 vs plain: {what}: ok", flush=True)

    # caps above 1024: level 2, Gaussian, densest cell 1060 (n 16,500) and 2284 (n 35,000)
    for cap, n in ((1088, 16_500), (2496, 35_000)):
        for periodic in (True, False):
            keys, cols, box = sorted_sample(dev, n, periodic, True, 7, 2)
            planes = ell_inputs(keys, *cols[:4], box, 2, cap, mass=cols[4])
            fullest = int(planes[-1].sum(dim=1).max())
            check(fullest > 1024, f"densest cell {fullest} should exceed 1024")
            what = f"level 2 cap {cap} densest cell {fullest} periodic {periodic}"
            compare_stencil(err, planes, box, 2, what, asym=True)
            print(f"B1/B2/B4 vs plain: {what}: ok", flush=True)

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

    # B6 on groups of 1, 33, 256 and 1024 over candidate counts that are no
    # multiple of its 256-candidate tile: an empty group, holes of -1 slots,
    # a target's own index at tile edges, targets with r2 < 0
    for G in (1, 33, 256, 1024):
        for C in (300, 4133):
            args = tuple(torch.from_numpy(a).to(dev) for a in dense_groups(G, 8, C, seed=G + C))
            want = neighbors_v1.pairwise_count_plain(*args)
            check(int(want.sum()) > 0 and int(want[1].sum()) == 0, "dense_groups should count, group 1 not")
            what = f"8 groups of {G}, {C} candidates with holes, self at tile edges"
            err.counts("pairwise_count", neighbors_v1.pairwise_count(*args), want, what)
            print(f"B6 vs plain: {what}: ok", flush=True)
    torch.cuda.synchronize()


# ----------------------------------------------------------------------------
# phase 4: the cell-list main path
# ----------------------------------------------------------------------------

def uniform_setup(dev):
    """multichip.uniform_setup's sample of N particles from SEED on dev, the
    input of phases 4, 6, 7 and paths E-J: uniform positions in the
    periodic unit box, the drift, h = default_h(N) (H), mass 1/N, the
    particle ids and the box."""
    from cstone_tpu_torch import multichip

    return multichip.uniform_setup(N, dev, SEED)


def drifted(xyz, drift, sgn):
    return tuple((c + sgn * drift[:, i]) % 1.0 for i, c in enumerate(xyz))


def main_path_phase(dev, card):
    """Phase 4: the port's cell-list timestep at full size through its public API."""
    import torch

    from cstone_tpu_torch.domain import Domain, sync_with_retry
    from cstone_tpu_torch.models import SphState, sph_density_step
    from cstone_tpu_torch.octree_build import cornerstone_ok
    from cstone_tpu_torch.ops import stencil
    from cstone_tpu_torch.sfc import PERIODIC, make_box
    from cstone_tpu_torch.traversal import cell_list_neighbor_counts, cell_list_sph_density, choose_cell_level

    setup = uniform_setup(dev)
    (x, y, z), drift, h = setup["xyz"], setup["drift"], setup["h"]
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
    check(launches["sfc_encode"] >= 1 + DRIFT_STEPS + SPH_STEPS, f"K1 should encode once a sync at least: {launches}")

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
    # B4 computes B1's function; then each kernel alone on the same inputs
    check(torch.equal(stencil.stencil_counts_asym(*counts_args), stencil.stencil_counts(*counts_args)),
          "the one-sided (B4) and half-stencil (B1) kernels disagree on the phase-4 counts")
    times = {}
    for name, args in (("stencil_counts", counts_args), ("stencil_density", density_args),
                       ("stencil_counts_asym", counts_args)):
        ms = cuda_time_ms(lambda: getattr(stencil, name)(*args), 20)
        plain = cuda_time_ms(lambda: getattr(stencil, name + "_plain")(*args), 3)
        b_ms, b_by = bounds[name]
        times[name] = (ms, plain)
        print(f"{name} at {shape}: kernel {ms:.4f} ms; bound {b_ms:.4f} ms ({b_by}), share of bound "
              f"{b_ms / ms:.4f}; plain {plain:.4f} ms [{card}]", flush=True)
    tests = stencil_pairs(valid, valid, flags, LEVEL, same=False)  # every ordered pair, self included
    w_ms, w_by = bound(tests * (OPS_D2 + OPS_CMP), stencil_bytes(valid, 4))
    print(f"stencil_counts_asym at {shape}: one-sided work bound ({tests:.6g} tests x {OPS_D2 + OPS_CMP} "
          f"operations) {w_ms:.4f} ms ({w_by}), share {w_ms / times['stencil_counts_asym'][0]:.4f} [{card}]",
          flush=True)
    launches = {k: launches[k] for k in ("stencil_counts", "stencil_density")}
    return launches, err, {k: {"ms": ms, "plain_ms": p, "shape": shape, "bound_ms": bounds[k][0],
                               "bound_by": bounds[k][1]} for k, (ms, p) in times.items()}, \
        (reference, caps["tree"])


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
    # the arguments it was given, timed at those shapes
    err = Errors()
    cross_ms = cross_plain_ms = cross_flops = cross_bytes = 0.0
    names = sorted(name for name, _, _ in calls)
    check(names == ["stencil_counts"] * len(levels) + ["stencil_cross"] * len(cross),
          f"path A launched {names}")
    for name, args, got in calls:
        want, plain_ms = timed_ms(lambda: plain_of(name)(*args))
        ms = device_time_ms(lambda: getattr(stencil, name)(*args), 5)
        if name == "stencil_cross":
            tgt, cand, level = args[0], args[1], args[4]
            lanes = "B" if stencil.cross_lanes_on_b(tgt[4], cand[4]) else "A"
            shape = (f"cross pass, level {level}, caps {tgt[0].shape[1]}/{cand[0].shape[1]}, "
                     f"lanes on {lanes}")
            for g, w in zip(got, want):
                err.counts(name, g, w, shape)
            pairs = stencil_pairs(tgt[4], cand[4], args[3], level, same=False)
            shape += f", {pairs:.6g} pairs, {ms * 1e9 / max(pairs, 1.0):.4g} ps per pair"
            cross_ms += ms
            cross_plain_ms += plain_ms
            # both tables read once, both results written once; one d2 and
            # a compare at each end per cross pair
            cross_bytes += sum(stencil_bytes(t[4], 4) for t in (tgt, cand))
            cross_flops += (OPS_D2 + 2 * OPS_CMP) * pairs
        else:
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
    print(f"stencil_cross, {shape}: symmetric kernel {cross_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
          f"share of bound {b_ms / cross_ms:.4f} [{card}]", flush=True)
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

    setup = uniform_setup(dev)
    xyz, drift, h = setup["xyz"], setup["drift"], setup["h"]
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


def focus_tree_phase(dev, card):
    """Phase 7: Domain.sync with a focus tree built by focus_converge."""
    import torch

    from cstone_tpu_torch import octree_build as ob
    from cstone_tpu_torch.domain import Domain
    from cstone_tpu_torch.focus import octree_focus
    from cstone_tpu_torch.ops.cuda_lib import record_launches
    from cstone_tpu_torch.ops.keys64 import to_numpy
    from cstone_tpu_torch.sfc import PERIODIC, make_box
    from cstone_tpu_torch.traversal import cell_list_neighbor_counts, find_neighbors

    setup = uniform_setup(dev)
    xyz, drift, h = setup["xyz"], setup["drift"], setup["h"]
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
            launches[k] = launches.get(k, 0) + v - before[k]

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
        check(ob.fixed_point_ok(states["C"].global_tree, GLOBAL_BUCKET, f"{what}, global tree") == 0,
              f"{what}: a leaf of the global tree holds more than {GLOBAL_BUCKET}")
        ob.cornerstone_ok(states["C"].global_tree, N)

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
    from cstone_tpu_torch.octree_build import cornerstone_ok
    from cstone_tpu_torch.ops import mark_macs as mark_kernel
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

    # the walk's two versions on the card, on the same prepared arrays: the
    # kernel (one launch) and the plain breadth-first walk
    inputs = macs.prepare_marks(linked, centers, box, fs, fe, leaves, n_leaf, True)
    mark_kernel.reset_launches()
    walk = lambda: mark_kernel.mark_walk(*inputs, linked.child_offsets, box, 21)  # noqa: E731
    (kernel_marks, kernel_ms) = timed_ms(walk)
    kernel_ms = min([kernel_ms] + [timed_ms(walk)[1] for _ in range(4)])
    launches = mark_kernel.launches()["mark_walk"]
    tests = []
    (plain_marks, plain_ms) = timed_ms(lambda: macs.mark_walk_plain(inputs, linked.child_offsets, box, tests))
    check(launches == 5, f"the MAC walk launched {launches} times in 5 calls")
    check(torch.equal(kernel_marks, plain_marks) and torch.equal(marks, plain_marks),
          f"the MAC kernel's marks differ from the plain walk's at "
          f"{int((kernel_marks != plain_marks).sum())} nodes")
    n_tests = sum(tests)
    cap_nodes, cap_focus = linked.child_offsets.shape[0], leaves.shape[0] - 1
    # node centres, radii, child offsets and levels read, marks written;
    # target centres, sizes and levels read
    nbytes = cap_nodes * (16 + 8 + 4) + cap_focus * (12 + 12 + 4)
    bound_ms, bound_by = bound(n_tests * MAC_OPS, nbytes)
    print(f"MAC walk on the card: kernel {kernel_ms:.4f} ms (least of 5 launches, {launches} counted), plain "
          f"walk {plain_ms:.3f} ms, marks equal; the plain walk's tests {n_tests} ({len(tests)} criterion calls); "
          f"bound {bound_ms:.4f} ms ({bound_by}: {n_tests * MAC_OPS:.3e} FP32 operations, {nbytes} bytes), "
          f"kernel share {bound_ms / kernel_ms:.4f} [{card}]", flush=True)


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


def make_domain(comm, caps, mode, protocol, dev, window=0):
    from cstone_tpu_torch import multichip

    return multichip.make_domain(comm, caps, mode, protocol, dev, window, BUCKET, LET_THETA)


def rank_after(comm, domain, state, res, inp):
    """multichip.rank_after at phase 4's cell level and cap."""
    from cstone_tpu_torch import multichip

    return multichip.rank_after(comm, domain, state, res, inp, LEVEL, CAP)


def cold_step(comm, setup, caps0, mode, protocol):
    """multichip.cold_step with phase 4's bucket and theta: (state, res,
    span, input, domain, capacities, the comm's RankTally, reset before
    the step: the step's rounds and bytes)."""
    from cstone_tpu_torch import multichip

    c = multichip.cold_step(comm, setup, caps0, mode, protocol, 0, BUCKET, LET_THETA)
    return c.state, c.res, c.span, c.inp, c.domain, c.caps, c.tally


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

    from cstone_tpu_torch import multichip
    from cstone_tpu_torch.ops.cuda_lib import record_launches
    from cstone_tpu_torch.parallel import run_ranks
    from cstone_tpu_torch.traversal import macs

    R = LET_RANKS
    name = "E" if mode == "pool" else "F"
    setup = uniform_setup(dev)
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
            inputs = [multichip.drift_input(inp, setup["drift"], sgn) for inp in inputs]
            sgn = -sgn
            for t in tallies:
                t.reset()
            with RankTimer(macs, "mark_macs") as marking:
                outs = run_ranks(R, multichip.rank_sync, domains, states, inputs)
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
    check(launches["sfc_encode"] >= R * (1 + POOL_DRIFT_STEPS), f"K1 should encode once a rank's sync at least: "
          f"{launches}")
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
    the peak memory is read. (b) is multichip.rank_steps, the per-rank
    body of the multi-card steps mode."""
    from cstone_tpu_torch import multichip
    from cstone_tpu_torch.ops.cuda_lib import record_launches

    libs = libraries()
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
    setup = uniform_setup(comm.device)
    for protocol in ("dense", "ragged"):
        reset_all_launches()
        run = multichip.rank_steps(comm, setup, "p2p", protocol, 0, POOL_DRIFT_STEPS, LEVEL, CAP,
                                   first_caps(tree_cap), on_step=rank_record, bucket=BUCKET, theta=LET_THETA)
        out[protocol] = {"caps": run["caps"], "steps": run["extra"], "launches": all_launches(),
                         "err": run["plain_err"], "last_launched": run["last_launched"], "peak": run["peak"]}
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

    setup = uniform_setup(dev)
    xyz, h = setup["xyz"], setup["h"]
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
    from cstone_tpu_torch.grav_ranks import grav_setup
    from cstone_tpu_torch.models import nbody
    from cstone_tpu_torch.traversal.geometry import node_geometry

    setup = grav_setup(N, dev, H, SEED)
    xyz, m, h, box = setup["xyz"], setup["m"], setup["h"], setup["box"]

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
    """Path J's cold step on one rank (multichip.cold_try): a p2p Domain,
    dense protocol, over a peer window of `window` ranks, at path F's
    inputs and capacities, one sync. Returns (state, res, span, input,
    domain, the comm's RankTally, reset before the sync)."""
    from cstone_tpu_torch import multichip

    return multichip.cold_try(comm, setup, caps, "p2p", "dense", window, BUCKET, LET_THETA)


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
    multichip.rank_steps in the dense p2p mode at the window path J (a)
    converged to, its cold step alone: B1 and B2 on the rank's buffer,
    each launch held to its plain version there."""
    from cstone_tpu_torch import multichip

    libs = libraries()
    for lib in libs:
        lib.load()  # the libraries phase 2 built: loaded, never built here
    setup = uniform_setup(comm.device)

    def record(state, res, after, span, stats):
        rec = res.halo_record
        return rank_record(state, res, after, span, stats), (rec.window, rec.send_idx.shape[0])

    reset_all_launches()
    run = multichip.rank_steps(comm, setup, "p2p", "dense", window, 0, LEVEL, CAP, first_caps(tree_cap),
                               on_step=record, bucket=BUCKET, theta=LET_THETA)
    (rec, rows), = run["extra"]
    return {"built": [lib.source.name for lib in libs if lib.build_log], "rec": rec, "rows": rows,
            "launches": all_launches(), "launched": run["last_launched"], "err": run["plain_err"]}


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

    from cstone_tpu_torch import multichip
    from cstone_tpu_torch.domain import domain as domain_module
    from cstone_tpu_torch.ops.cuda_lib import record_launches
    from cstone_tpu_torch.parallel import run_ranks
    from cstone_tpu_torch.parallel.dist import spawn_ranks

    R = LET_RANKS
    setup = uniform_setup(dev)
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
        want = max(multichip.window_need(d, st, res) for d, st, res in zip(domains, states, results))
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
            inputs = [multichip.drift_input(inp, setup["drift"], sgn) for inp in inputs]
            sgn = -sgn
            for t in tallies:
                t.reset()
            with RankTimer(domain_module, "find_peers_mac") as peers:
                outs = run_ranks(R, multichip.rank_sync, domains, states, inputs)
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


# ----------------------------------------------------------------------------
# phase 15: path L, the library's own octree build (bench.py's tree mode)
# ----------------------------------------------------------------------------

OCTREE_REPS = 3
OCTREE_CONFIGS = (  # (name, keys, key width, curve): bench.py's two cells, octree.cu:70-115's Morton, 32-bit keys
    ("octree_build_2M", 2_000_000, np.uint64, "hilbert"),
    ("octree_build_64M", 64_000_000, np.uint64, "hilbert"),
    ("octree.cu, Morton", 2_000_000, np.uint64, "morton"),
    ("uint32 Hilbert", 2_000_000, np.uint32, "hilbert"),
)


def to_cpu(tree):
    """A tree of tensors (utils/tree.py) with every tensor moved to the CPU."""
    import torch

    from cstone_tpu_torch.utils.tree import tree_leaves, tree_unflatten

    return tree_unflatten(tree, [a.cpu() if isinstance(a, torch.Tensor) else a for a in tree_leaves(tree)])


def same_on_cpu(what, got, want) -> None:
    """Every tensor of `got` (computed on the card) equal to `want` (the
    same function on the CPU copies of its inputs), bit for bit."""
    import torch

    from cstone_tpu_torch.utils.tree import tree_leaves

    a, b = tree_leaves(got), tree_leaves(want)
    check(len(a) == len(b), f"{what}: {len(a)} results on the card, {len(b)} on the CPU")
    for i, (x, y) in enumerate(zip(a, b)):
        if isinstance(x, torch.Tensor):
            check(x.shape == y.shape and torch.equal(x.cpu(), y), f"{what}: result {i} differs from the CPU run's")
        else:
            check(x == y, f"{what}: result {i} differs from the CPU run's")


def card_and_cpu(what, fn, *args):
    """fn on the card's arguments and on their CPU copies, held equal; the
    card's result and the ms of both calls."""
    cpu_args = to_cpu(list(args))
    got, ms = timed_ms(lambda: fn(*args))
    t0 = time.perf_counter()
    want = fn(*cpu_args)
    cpu_ms = 1e3 * (time.perf_counter() - t0)
    same_on_cpu(what, got, want)
    return got, ms, cpu_ms


def octree_leaves_phase(dev, card, run, curve) -> dict:
    """The leaf modules no other path runs, on path L's 2M tree, each on the
    card against the same call on the CPU: compute_spanning_tree of an
    8-way split of the tree by counts, build_binary_tree over its leaf
    keys, compute_continuum_csarray of a rational concentration (the
    same correctly rounded operations on both), stencil_stats of the keys'
    level-5 cell table."""
    import torch

    from cstone_tpu_torch import octree_build as ob
    from cstone_tpu_torch.ops.primitives import searchsorted
    from cstone_tpu_torch.sfc import PERIODIC, make_box
    from cstone_tpu_torch.sfc.keys import node_range
    from cstone_tpu_torch.traversal.celllist import rowmajor_cell_perm, stencil_stats
    from cstone_tpu_torch.traversal.cover import build_cell_table
    from cstone_tpu_torch.tree import btree, continuum, csarray

    tree, keys = run["tree"], run["keys"]
    nn = int(tree.n_nodes)
    kdt = tree.keys.dtype
    ms = {}
    cum = torch.cumsum(tree.counts[:nn], 0)
    at = searchsorted(cum, torch.arange(1, 8, device=dev) * (keys.shape[0] // 8), side="right") + 1
    split = torch.cat([tree.keys[:1], tree.keys[at], tree.keys.new_full((1,), node_range(kdt, 0))])
    (span, n_span), ms["compute_spanning_tree"], _ = card_and_cpu(
        "compute_spanning_tree", csarray.compute_spanning_tree, split, 8, 4096)
    bt, ms["build_binary_tree"], _ = card_and_cpu("build_binary_tree", btree.build_binary_tree, tree.keys[:nn], nn)
    check(int(bt.n_internal) == nn - 1, "build_binary_tree: n - 1 internal nodes")

    def blob(x, y, z):
        r2 = (x - 0.5) * (x - 0.5) + (y - 0.5) * (y - 0.5) + (z - 0.5) * (z - 0.5)
        return 4.0e6 / (1.0 + 60.0 * r2)

    def continuum_tree(box):
        return continuum.compute_continuum_csarray(blob, box, ob.BUCKET, 262_144, np.uint64, curve=curve)

    box = make_box(0.0, 1.0, boundaries=PERIODIC, device=dev)
    ct, ms["compute_continuum_csarray"], _ = card_and_cpu("compute_continuum_csarray", continuum_tree, box)
    perm = rowmajor_cell_perm(5, curve, device=dev)[0]
    (pairs, occ), ms["stencil_stats"], _ = card_and_cpu(
        "stencil_stats", lambda k, p: stencil_stats(build_cell_table(k, 5), p, 5), keys, perm)
    print(f"path L, leaves on the 2M tree, each bit-equal to the CPU run of the same inputs: spanning tree of an "
          f"8-way split {int(n_span)} nodes, binary radix tree {int(bt.n_internal)} internal nodes, continuum tree "
          f"{int(ct.n_nodes)} leaves, stencil_stats at level 5: {float(pairs):.6e} pairs, densest cell {int(occ)}; "
          f"ms on the card {json.dumps({k: round(v, 3) for k, v in ms.items()})} [{card}]", flush=True)
    return ms


def octree_phase(dev, card) -> dict:
    """Phase 15, path L: octree_build.octree_build_path at OCTREE_CONFIGS on
    the card, each held to the host oracle (octree_build.octree_checks);
    the leaf modules on the 2M uint64 Hilbert tree (octree_leaves_phase)."""
    import torch

    from cstone_tpu_torch import octree_build as ob

    out = {}
    reset_all_launches()
    for name, n, kdt, curve in OCTREE_CONFIGS:
        what = f"path L, {name}"
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        run = ob.octree_build_path(dev, n, kdt, curve, reps=OCTREE_REPS)
        peak = torch.cuda.max_memory_allocated(dev)
        run_s = time.perf_counter() - t0
        oracle_s, deep = ob.octree_checks(what, run, n, kdt, curve)
        ms = run["ms"]
        rec = {"n": n, "key_bits": 8 * np.dtype(kdt).itemsize, "curve": curve, "capacity": run["capacity"],
               "regrown": run["regrown"], "build_iterations": run["iters"], "update_steps": len(run["steps"]),
               "n_nodes": int(run["tree"].n_nodes), "n_nodes_update": int(run["steps"][-1][0].n_nodes),
               "build_ms": ms["build"], "update_step_ms": ms["update_step"], "update_ms": ms["update"],
               "keys_per_s": n / (ms["build"]["median"] * 1e-3), "peak_bytes": peak, "oracle_s": oracle_s,
               "deepest_over_bucket": deep, "seconds": run_s}
        fmt = lambda q: f"{q['median']:.3f} ms (quartiles {q['q1']:.3f} / {q['q3']:.3f})"  # noqa: E731
        print(f"{what}: {n} keys, uint{rec['key_bits']} {curve}, bucket {ob.BUCKET}, capacity {run['capacity']}"
              f"{' (regrown)' if run['regrown'] else ''}: build {run['iters']} rebalance iterations, {rec['n_nodes']} "
              f"nodes; update to convergence {len(run['steps'])} steps, {rec['n_nodes_update']} nodes; median of "
              f"{OCTREE_REPS}: build {fmt(ms['build'])}, {rec['keys_per_s']:.6e} keys/s; one update step "
              f"{fmt(ms['update_step'])}; update to convergence {fmt(ms['update'])}; peak memory allocated {peak} "
              f"bytes; bit-equal to the host oracle (its two trees {oracle_s:.3f} s); leaves at the deepest level "
              f"above the bucket {deep}; {run_s:.3f} s for the path [{card}]", flush=True)
        if name == "octree_build_2M":
            rec["leaves_ms"] = octree_leaves_phase(dev, card, run, curve)
        out[name] = rec
        del run
    launches = all_launches()
    print(f"path L launches: {json.dumps(launches)}", flush=True)
    no_cell_list_kernel(launches, "path L")
    return out


# ----------------------------------------------------------------------------
# phase 16: path M, syncGrav on LET_RANKS ranks
# ----------------------------------------------------------------------------

GRAV_DRIFT_STEPS = 1  # each 8-rank syncGrav step holds all 1M particles on every rank


def grav_leaves_phase(dev, card, ref, outs) -> None:
    """The modules no other path runs, on path M's syncs, each on the card
    against the same call on the CPU copies of its inputs: Halos
    (discover, compute_layout, exchange) at one rank on the one-rank cold
    step's focus tree, the middle third of its leaves taken as the rank's
    own; exchange_focus_quantities of the 8 p2p ranks' leaf counts;
    ParticleFields and get_fields; save_checkpoint / load_checkpoint of
    rank 0's DomainState on the card, back onto the card and onto the CPU."""
    import tempfile

    import torch

    from cstone_tpu_torch.fields import ParticleFields, get_fields
    from cstone_tpu_torch.focus.exchange_focus import exchange_focus_quantities
    from cstone_tpu_torch.halos import Halos
    from cstone_tpu_torch.ops.keys64 import key_const
    from cstone_tpu_torch.parallel import run_ranks
    from cstone_tpu_torch.sfc.keys import node_range
    from cstone_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
    from cstone_tpu_torch.utils.tree import tree_leaves

    ms = {}
    state, res = ref["state"], ref["res"]
    tree, n = res.tree, int(res.end_index)
    n_leaf = int(tree.n_leaf)
    first, last = n_leaf // 3, 2 * n_leaf // 3
    bounds = torch.tensor([0, key_const(node_range(np.uint64, 0), np.uint64)], dtype=torch.int64, device=dev)

    def halos(tree, keys, h, x, counts, bounds, box):
        hs = Halos()
        flags = hs.discover(tree, h, n, keys, first, last, box)
        layout, start, end, rec = hs.compute_layout(tree, counts, flags, first, last, bounds, keys, n, n_leaf, n)
        return flags, layout, start, end, rec, hs.exchange(x, torch.zeros_like(x), rec)

    (flags, _, _, _, rec, _), ms["halos"], ms["halos_cpu"] = card_and_cpu(
        "Halos", halos, tree, res.keys, res.h, res.x, res.leaf_counts, bounds, state.box)
    check(int(rec.overflow) == 0 and 0 < int(flags.sum()) < n_leaf - (last - first), "Halos: overflow or no halos")

    def focus_exchange(comm, leaves, values, assignment):
        return exchange_focus_quantities(leaves, values, assignment, comm.rank, comm)

    args = [[o["res"].tree.leaves for o in outs], [o["res"].leaf_counts for o in outs],
            [o["state"].assignment for o in outs]]
    got, ms["exchange_focus"] = timed_ms(lambda: run_ranks(len(outs), focus_exchange, *args))
    want = run_ranks(len(outs), focus_exchange, *to_cpu(args))
    same_on_cpu("exchange_focus_quantities", got, want)
    check(all(bool(m[:int(o["res"].tree.n_leaf)].any()) for (_, m), o in zip(got, outs)),
          "exchange_focus_quantities matched no leaf")

    def fields(x, y, z, m):
        d = ParticleFields(x.shape[0], device=x.device)
        for name, v in (("x", x), ("y", y), ("z", z), ("m", m)):
            d.add(name, v, conserved=name != "m")
        d.acquire("ax", "ay")
        d["ax"] = d["x"] * d["m"]
        d.release("ay")
        return get_fields(d, "x", "m", "ax"), d.names()

    _, ms["fields"], _ = card_and_cpu("ParticleFields", fields, res.x, res.y, res.z, res.properties[0])

    st = outs[0]["state"]
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/state.pt"
        t0 = time.perf_counter()
        save_checkpoint(path, st)
        back = load_checkpoint(path, st)
        ms["checkpoint"] = 1e3 * (time.perf_counter() - t0)
        on_cpu = load_checkpoint(path, to_cpu(st))
    check(all(a.device.type == "cuda" for a in tree_leaves(back) if isinstance(a, torch.Tensor)),
          "load_checkpoint: the round trip left the card")
    same_on_cpu("checkpoint round trip of a DomainState on the card", back, on_cpu)
    same_on_cpu("checkpoint round trip against the state", back, to_cpu(st))
    print(f"path M, modules on its syncs, each equal to the CPU run of the same inputs: Halos at one rank "
          f"({int(flags.sum())} halo leaves of {n_leaf}), exchange_focus_quantities on {len(outs)} ranks, "
          f"ParticleFields, a checkpoint round trip of rank 0's DomainState; ms "
          f"{json.dumps({k: round(v, 3) for k, v in ms.items()})} [{card}]", flush=True)


def grav_ranks_phase(dev, card, tree_cap) -> dict:
    """Phase 16, path M: syncGrav + update_expansion_centers on LET_RANKS
    thread ranks of path I (b)'s particles, pool then p2p, a cold step
    under sync_with_retry from path F's capacities and GRAV_DRIFT_STEPS
    drift steps (grav_ranks.grav_steps), held to the one-rank run of the
    same steps and to the float64 oracle (grav_ranks.rank_checks on the
    thread ranks); the foreign leaves recomputed from plain float32 prefix
    sums and the lower-precision control (grav_ranks.prefix_sum_readings),
    which the outside limit must refuse; then the modules no other path
    runs (grav_leaves_phase)."""
    import torch

    from cstone_tpu_torch import grav_ranks as gr
    from cstone_tpu_torch.parallel import run_ranks

    R = LET_RANKS
    reset_all_launches()
    setup = gr.grav_setup(N, dev, H, SEED)
    t0 = time.perf_counter()
    ref, ref_caps = gr.grav_steps(None, setup, {"tree": tree_capacity(N)}, None, GRAV_DRIFT_STEPS, BUCKET, GRAV_THETA)
    ref_gap = max(gr.one_rank_checks(f"path M, one rank, step {s}", r) for s, r in enumerate(ref))
    print(f"path M: one-rank syncGrav, {N} particles, theta {GRAV_THETA}, bucket {BUCKET}: sync ms "
          f"{json.dumps([round(1e3 * (s['span'][1] - s['span'][0]), 3) for s in ref])} (cold, then drift), "
          f"capacities {ref_caps}, focus nodes {[int(s['res'].tree.n_nodes) for s in ref]}; centres "
          f"{ref_gap:.3e} off the float64 oracle at most; {time.perf_counter() - t0:.3f} s [{card}]", flush=True)
    runs = {}
    for mode in ("pool", "p2p"):
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        outs = run_ranks(R, lambda comm: gr.grav_steps(comm, setup, first_caps(tree_cap), mode, GRAV_DRIFT_STEPS,
                                                       BUCKET, GRAV_THETA))
        run_s = time.perf_counter() - t0
        caps = outs[0][1]
        check(all(o[1] == caps for o in outs), f"path M, {mode}: the ranks grew different capacities")
        steps = [[o[0][s] for o in outs] for s in range(1 + GRAV_DRIFT_STEPS)]
        for s, per in enumerate(steps):
            what = f"path M, {mode}, " + ("cold step" if s == 0 else f"drift step {s}")
            sums = gr.step_sums(ref[s])
            pools = [gr.slot_record(p) for p in runs["pool"][s]] if mode == "p2p" else [None] * R
            cmp = run_ranks(R, lambda comm, o, p: gr.rank_checks(what, comm, o, ref[s], sums, p), per, pools)
            readings = gr.prefix_sum_readings(per, ref[s], sums)
            f32 = max(max(x["float32"]) for x in readings)
            control = min(max(x["control"]) for x in readings)
            check(f32 <= gr.OUTSIDE_UNITS < control,
                  f"{what}: plain float32 prefix sums {f32:.3e} and the {gr.CONTROL_BITS}-bit control {control:.3e} "
                  f"rounding units off the oracle; the limit {gr.OUTSIDE_UNITS} must pass the first and refuse the "
                  f"second")
            wall = 1e3 * (max(o["span"][1] for o in per) - min(o["span"][0] for o in per))
            stats = [o["stats"] for o in per]
            print(f"{what}: {R}-rank sync wall {wall:.3f} ms; per rank sync ms "
                  f"{json.dumps([round(1e3 * (o['span'][1] - o['span'][0]), 3) for o in per])}; all_to_all rounds "
                  f"per rank {json.dumps([x['all_to_all'] for x in stats])}, their buffer bytes per rank "
                  f"{json.dumps([x['all_to_all_bytes'] for x in stats])}; owned "
                  f"{[int(o['res'].end_index) - int(o['res'].start_index) for o in per]}, halo particles "
                  f"{[int(o['res'].n_with_halos) - int(o['res'].end_index) + int(o['res'].start_index) for o in per]}"
                  f"; focus nodes {[c['nodes'] for c in cmp]}, shared with the one-rank tree "
                  f"{[c['shared'] for c in cmp]}, in the rank's own range and held to rtol {gr.CENTER_RTOL}: "
                  f"{[c['held'] for c in cmp]}, largest gap there {max(c['gap'] for c in cmp):.3e}; outside, rounding "
                  f"units off the float64 oracle (limit {gr.OUTSIDE_UNITS}): positions "
                  f"{json.dumps([round(c['pos'], 4) for c in cmp])}, masses "
                  f"{json.dumps([round(c['mass'], 4) for c in cmp])}, the same leaves from plain float32 prefix sums "
                  f"{f32:.4f}, from {gr.CONTROL_BITS}-bit prefix sums (control) {control:.4f} at least [{card}]",
                  flush=True)
        peak = torch.cuda.max_memory_allocated(dev)
        print(f"path M, {mode}: capacities {caps}; {run_s:.3f} s for the cold step (its retry included) and "
              f"{GRAV_DRIFT_STEPS} drift steps with update_expansion_centers; peak memory allocated {peak} bytes"
              + ("; every rank equal to pool at every step" if mode == "p2p" else "") + f" [{card}]", flush=True)
        runs[mode] = steps
    launches = all_launches()
    print(f"path M launches: {json.dumps(launches)}", flush=True)
    no_cell_list_kernel(launches, "path M")
    grav_leaves_phase(dev, card, ref[0], runs["p2p"][-1])
    return runs


# ----------------------------------------------------------------------------
# phase 17: path N, multichip's grav steps mode on rank processes
# ----------------------------------------------------------------------------

GRAV_PROC_RANKS = 4


def grav_processes_phase(dev, card) -> dict:
    """Phase 17, path N: multichip.grav_rank on GRAV_PROC_RANKS rank
    processes sharing the card over gloo, as the module docstring says.
    Each process prints nothing but rank 0's progress; the lines come
    from multichip.report_grav here. Returns its summary."""
    from cstone_tpu_torch import multichip
    from cstone_tpu_torch.parallel.dist import spawn_ranks

    R = GRAV_PROC_RANKS
    cfg = multichip.grav_config(N, R, GRAV_DRIFT_STEPS, multichip.STEP_MODES)
    t0 = time.perf_counter()
    recs = spawn_ranks(R, multichip.grav_rank, [cfg] * R, backend="gloo", device=dev, timeout=600.0,
                       deadline=900.0)
    seconds = time.perf_counter() - t0
    summary = multichip.report_grav(recs, cfg, "gloo", seconds, tag="path N, ")
    for rec in recs:
        no_cell_list_kernel(rec["launches"], f"path N, rank {rec['rank']}")
    print(f"path N: {R} rank processes on the card over gloo, {N} particles, modes {cfg['modes']}, a cold and "
          f"{GRAV_DRIFT_STEPS} drift step each, every rank's every step held: {seconds:.3f} s, the rank processes' "
          f"start included; B1-B6 launches 0, K1 encodes per rank "
          f"{json.dumps([rec['launches']['sfc_encode'] for rec in recs])} [{card}]", flush=True)
    return summary


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


def sfc_codec_phase(dev, card) -> dict:
    """Phase 18: the Hilbert key codec's kernel against the plain codec on
    the card at CODEC_N particles, uint64 keys; returns the times."""
    import torch

    from cstone_tpu_torch.ops import sfc_codec
    from cstone_tpu_torch.sfc import PERIODIC, compute_sfc_keys, make_box
    from cstone_tpu_torch.sfc import hilbert
    from cstone_tpu_torch.sfc.encode import _grid_coords, _grid_scale, decode_sfc

    g = torch.Generator(device=dev).manual_seed(SEED)
    x, y, z = torch.rand(3, CODEC_N, device=dev, generator=g).unbind(0)
    box = make_box(0.0, 1.0, boundaries=PERIODIC, device=dev)
    sfc_codec.reset_launches()
    encode = lambda: compute_sfc_keys(x, y, z, box, np.uint64)  # noqa: E731
    plain_encode = lambda: hilbert.ihilbert(*_grid_coords(x, y, z, box, np.uint64), np.uint64)  # noqa: E731
    keys = encode()
    coords = decode_sfc(keys)
    check(sfc_codec.launches() == {"encode": 1, "decode": 1},
          f"the codec launched {sfc_codec.launches()} for one encode and one decode")
    # the plain codec's first calls, which also load torch's kernels
    plain_keys, plain_coords = plain_encode(), hilbert.decode_hilbert(keys)
    check(torch.equal(keys, plain_keys), f"the codec's keys differ from the plain codec's at "
          f"{int((keys != plain_keys).sum())} of {CODEC_N} particles")
    check(all(torch.equal(a, b) for a, b in zip(coords, plain_coords)),
          "the codec's decode differs from the plain codec's")
    sfc_grid_checks(dev, card)
    plain_encode_ms = timed_ms(plain_encode)[1]
    plain_decode_ms = timed_ms(lambda: hilbert.decode_hilbert(keys))[1]
    # device time of the launches alone: the host issues a call's few
    # torch operations more slowly than the card runs the kernel
    scale = torch.cat(_grid_scale(box, torch.float32, np.uint64))
    encode_ms = device_time_ms(lambda: sfc_codec.encode_coords(x, y, z, scale, np.uint64), CODEC_REPS)
    decode_ms = device_time_ms(lambda: sfc_codec.decode(keys), CODEC_REPS)
    out = {}
    for what, ms, plain_ms, nbytes, ops in (
            ("encode", encode_ms, plain_encode_ms, CODEC_N * (3 * 4 + 8), CODEC_N * 21 * OPS_ENCODE_ROUND),
            ("decode", decode_ms, plain_decode_ms, CODEC_N * (8 + 3 * 8), CODEC_N * 21 * OPS_DECODE_ROUND)):
        bound_ms, ops_ms = nbytes / HBM_PEAK * 1e3, ops / INT32_PEAK * 1e3
        print(f"K1 {what} at {CODEC_N} particles, uint64 keys: kernel {ms:.4f} ms (device time of {CODEC_REPS} "
              f"queued calls), bound {bound_ms:.4f} ms (bytes: {nbytes}), share {bound_ms / ms:.4f}; integer operations "
              f"as written {ops:.3e}, {ops_ms:.4f} ms at INT32_PEAK; plain codec {plain_ms:.3f} ms (one warm "
              f"call); bit-equal [{card}]", flush=True)
        out[what] = {"kernel_ms": ms, "bound_ms": bound_ms, "ops_ms": ops_ms, "plain_ms": plain_ms}
    return out


def sfc_grid_checks(dev, card) -> None:
    """Phase 18: K1's integer encode (encode_grid) as its callers launch
    it, uint32 and uint64 keys, each call one launch and bit-equal to the
    plain rounds on the card (or, for contained_in_keys, to the same call
    on the CPU): isfc_key on CODEC_N int64 coordinates from -cube to
    2 cube - 1, the 7^3 combinations of the grid's edges and their
    neighbours first; contained_in_keys on the boxes of CONTAIN_N random
    nodes extended by one cell, as macs.prepare_marks makes them (those at
    the grid's faces reach -1 and cube), and by a halo radius of up to 1/8
    of the box, as collisions.find_halos' make_halo_box does in a
    periodic box; isfc_key_top at every level count with 3*levels <= 30
    on cell corners as cover.py makes them (coordinate << shift)."""
    import torch

    from cstone_tpu_torch.ops import sfc_codec
    from cstone_tpu_torch.sfc import hilbert, isfc_key
    from cstone_tpu_torch.sfc.box import IBox
    from cstone_tpu_torch.sfc.encode import isfc_key_top, sfc_ibox
    from cstone_tpu_torch.sfc.keys import max_tree_level
    from cstone_tpu_torch.traversal.boxoverlap import contained_in_keys

    g = torch.Generator(device=dev).manual_seed(SEED + 18)

    def launched(fn, encodes, what):
        before = sfc_codec.launches()["encode"]
        out = fn()
        check(sfc_codec.launches()["encode"] == before + encodes, f"{what}: {encodes} encode launches expected, "
              f"{sfc_codec.launches()['encode'] - before} made")
        return out

    outside, inside = {}, {}
    for kdt in (np.uint32, np.uint64):
        lmax = max_tree_level(kdt)
        cube = 1 << lmax
        c = torch.randint(-cube, 2 * cube, (3, CODEC_N), device=dev, generator=g)
        edges = torch.tensor([-cube, -1, 0, 1, cube - 1, cube, 2 * cube - 1], device=dev)
        corners = torch.stack(torch.meshgrid(edges, edges, edges, indexing="ij")).reshape(3, -1)
        c[:, :corners.shape[1]] = corners
        keys = launched(lambda: isfc_key(*c, kdt), 1, f"isfc_key, {kdt.__name__}")
        check(torch.equal(keys, hilbert.ihilbert(*c, kdt)),
              f"isfc_key, {kdt.__name__}: the codec's keys differ from the plain codec's at "
              f"{int((keys != hilbert.ihilbert(*c, kdt)).sum())} of {CODEC_N} coordinates")

        # random nodes: the start key of a random cell's level-lvl ancestor
        lvl = torch.randint(1, lmax + 1, (CONTAIN_N,), device=dev, generator=g)
        cell = hilbert.ihilbert(*torch.randint(0, cube, (3, CONTAIN_N), device=dev, generator=g), kdt)
        start = cell.to(torch.int64) & ~((torch.ones_like(lvl) << 3 * (lmax - lvl)) - 1)
        node = sfc_ibox(start.to(keys.dtype), lvl)
        radius = torch.randint(0, cube // 8 + 1, (CONTAIN_N,), device=dev, generator=g)
        boxes = {"extended": IBox(node.xmin - 1, node.xmax + 1, node.ymin - 1, node.ymax + 1, node.zmin - 1,
                                  node.zmax + 1),
                 "halo": IBox(node.xmin - radius, node.xmax + radius, node.ymin - radius, node.ymax + radius,
                              node.zmin - radius, node.zmax + radius)}
        span = 1 << 3 * lmax
        for name, box in boxes.items():
            lo = torch.minimum(torch.minimum(box.xmin, box.ymin), box.zmin)
            hi = torch.maximum(torch.maximum(box.xmax, box.ymax), box.zmax)
            outside[f"{name} {kdt.__name__}"] = int(((lo < 0) | (hi > cube)).sum())
            on_cpu = IBox(*(getattr(box, f).cpu() for f in ("xmin", "xmax", "ymin", "ymax", "zmin", "zmax")))
            for first, last in ((span // 4, span // 2), (0, span // 2)):
                got = launched(lambda: contained_in_keys(box, first, last, kdt), 2,
                               f"contained_in_keys, {name} boxes, {kdt.__name__}")
                want = contained_in_keys(on_cpu, first, last, kdt)
                check(torch.equal(got.cpu(), want), f"contained_in_keys, {name} boxes, {kdt.__name__}, range "
                      f"[{first}, {last}): the card and the CPU differ at {int((got.cpu() != want).sum())} boxes")
                inside[f"{name} {kdt.__name__} [{first}, {last})"] = int(want.sum())

        # cell corners at full resolution: a coordinate at resolution
        # `shift` bits coarser, shifted back up
        shift = torch.randint(0, lmax + 1, (CODEC_N,), device=dev, generator=g)
        top = [torch.randint(0, cube, (CODEC_N,), device=dev, generator=g) >> shift << shift for _ in range(3)]
        for levels in range(0, min(lmax, 10) + 1):
            got = launched(lambda: isfc_key_top(*top, levels, lmax), 1, f"isfc_key_top, levels {levels}")
            check(torch.equal(got, hilbert.ihilbert_top(*top, levels, lmax)),
                  f"isfc_key_top, {kdt.__name__}, levels {levels}: the codec differs from the plain codec")
    print(f"K1 integer encode, uint32 and uint64 keys: isfc_key on {CODEC_N} int64 coordinates in [-cube, 2 cube) "
          f"and contained_in_keys on {CONTAIN_N} node boxes (boxes reaching outside the grid: "
          f"{json.dumps(outside)}; inside the range: {json.dumps(inside)}) over two key ranges, each bit-equal to the plain codec; isfc_key_top at levels "
          f"0-10 bit-equal; one launch an encode [{card}]", flush=True)


def build_all():
    """Build every registered kernel library in parallel, one nvcc each,
    and the host C++ oracle of path L with g++ beside them."""
    from cstone_tpu_torch import native

    libs = libraries()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs) + 1) as pool:
        host = pool.submit(native.available)  # path L's oracle, g++ beside the nvcc builds
        list(pool.map(lambda lib: lib.load(), libs))
        host = host.result()
    print(f"{len(libs)} kernel libraries built and loaded in {time.perf_counter() - t0:.3f} s; the host C++ "
          f"oracle {'built' if host else 'did not build (g++ missing or its build failed)'}", flush=True)
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

    phase("15 path L: the octree build of bench.py's tree mode, held to the host C++ oracle")
    octree_phase(dev, card)

    phase("16 path M: syncGrav on 8 ranks, pool and p2p, against one rank")
    grav_ranks_phase(dev, card, tree_cap)

    phase("17 path N: multichip's grav steps mode on 4 rank processes over gloo, four modes, against one card")
    grav_processes_phase(dev, card)

    phase("18 the Hilbert key codec (K1) at the main path's shapes")
    sfc_codec_phase(dev, card)

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
