"""The multi-rank runs of the Domain, each rank its own process.

The dry run: one Domain.sync per rank, then a neighbour count over every
rank's buffer, held to the O(n^2) count of the same particles
(counterpart of the JAX package's `__graft_entry__.dryrun_multichip`;
reference: the flagship invariant of
test/integration_mpi/domain_nranks.cpp).

    python -m cstone_tpu_torch.multichip --ranks 8 --backend gloo [--device cpu]
    torchrun --nproc-per-node N -m cstone_tpu_torch.multichip --backend nccl

The first form spawns the ranks (parallel/dist.spawn_ranks); under gloo
they may share one card (the default device) or run on the CPU. The
second runs one rank in each process torchrun starts (comm_from_env),
one card a rank under nccl.

Each rank starts from a contiguous slice of n_per_rank uniform particles
in [-1, 1)^3 (seed 1), h = 0.08 at JAX's 256 particles a rank and
scaled by n^-1/3 above it (the same neighbours a particle), local
capacity 8 x n_per_rank, buckets 16/8, an open box. The dense protocol
runs first, then the ragged one with JAX's totals; both are held to:
every rank alive, overflow 0 (the neighbour pass's caps folded in as JAX
does: a watermark AT its cap counts), every particle assigned, and the
neighbour counts of the owned particles summing to the brute-force
count (exactly at 256 particles a rank, as JAX checks; above it, within
the pairs that float32 rounding may move across their radius). At 8
ranks of 256 the capacities are JAX's; above 2048 particles they grow
with the particle count. The neighbour pass takes JAX's caps, with the
filled slots as targets and the halo slots searching with radius 0 (JAX
makes every slot a target and sums the owned ones; the sum is the same).
On the card it takes the run-streaming kernel (use_pallas="v2", B5); on
the CPU its plain route.

The steps mode (`--steps S`): the Domain's timestep on every rank,
bench.py's `sync_<n>_uniform` sample split over the ranks.

    torchrun --standalone --nproc-per-node 4 -m cstone_tpu_torch.multichip \
        --backend nccl --steps 3 --n-total 4000000
    python -m cstone_tpu_torch.multichip --ranks 4 --backend gloo --device cpu \
        --steps 2 --n-total 8000

n uniform particles in the periodic unit box (seed 42), h = default_h(n)
(58 neighbours a particle), mass 1/n, bench.py's oscillating drift; the
cell level from choose_cell_level, the ELL cap default_cell_cap(n,
level, 3), bucket 64, theta 0.5, the tree capacity of bench.py and a
local capacity of about 2.1 x n / R. Rank r starts from the strided slice
r::R, so the first exchange moves nearly every particle. In each mode
(STEP_MODES: pool, dense p2p, ragged p2p, dense p2p over a peer window
grown from 1) every rank runs `rank_steps`: a cold step (the capacity
retry on the largest overflow of all ranks), then S drift steps, each a
Domain.sync, B1 (cell_list_neighbor_counts) and B2 (cell_list_sph_density)
over the rank's buffer, reapply_sync of the particle ids, exchange_halos
of the owned ids and compact_owned for the next input. Every rank first
runs the one-rank reference of the same particles and steps on its own
device (`reference_steps`: Domain(comm=None), B1, B2), so no rank waits
on another's reference. Held, at every step and rank, and raised
otherwise: the global tree bit-equal to the reference's, overflow 0,
every particle owned by exactly one rank, B1 counts by particle id
bit-equal, B2 densities within rtol 1e-5, the ids exchange_halos puts in
every slot those of the particles there (their positions equal the
reference's), the mean neighbour count 57.9 +- 0.5 and the mean density
within 2% of 1 + 1/(pi h^3 n); the modes equal to the first slot for
slot; every B1/B2 launch of the last step equal to its plain version.
Then (`--sim-steps`, default 2) the simulation loop (models/simulation)
on the same particles, held to its one-rank run. Rank 0 (or the parent)
prints one line a mode and step and, last, one JSON line.

The grav steps mode (`--steps S --grav`): syncGrav, the counterpart of
the JAX package's Domain.sync(grav=True) + update_expansion_centers
under shard_map (domain.hpp:246-325), in the same four modes.

    torchrun --standalone --nproc-per-node 4 -m cstone_tpu_torch.multichip \
        --backend nccl --steps 2 --grav --n-total 4000000
    python -m cstone_tpu_torch.multichip --ranks 4 --backend gloo --device cpu \
        --steps 1 --grav --n-total 8000

The particles of grav_ranks.grav_setup (normal(0, 0.25) clipped to
+-0.99 in the open box [-1, 1], masses uniform(0.5, 1.5), h 0.012, theta
0.4, bucket 64, seed 42), rank r starting from the strided slice r::R at
first_caps. Every rank first runs the one-card run of the same particles
and steps on its own device (`grav_reference_steps`), then each mode
(`grav_rank_steps`, pool first): a cold step under sync_with_retry (the
window grown from 1 to R - 1 by overflow_detail[6] in window mode), S
drift steps, each sync followed by update_expansion_centers. Every rank
holds its own steps (grav_ranks.rank_checks), raising otherwise: overflow
0, the owned ids a partition (one all_reduce), its own nodes' centres
and MAC spheres within rtol 1e-5 of the one-card run, every other node's
centre within 16 rounding units of the float64 centre of mass, the p2p
modes equal to pool slot for slot. No simulation loop follows; syncGrav
launches none of the cell-list kernels, and on a card encodes and
decodes its keys through the key codec (`sfc_encode`, `sfc_decode` in
the launch counts).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys
import time
import traceback
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

__all__ = ["dryrun_multichip", "rank_step", "particles", "brute_force_pairs", "PROTOCOLS", "STEP_MODES",
           "RankTally", "uniform_setup", "rank_steps", "run_modes", "reference_steps", "steps_rank",
           "grav_config", "grav_reference_steps", "grav_rank_steps", "grav_rank", "report_grav"]

PROTOCOLS = ("dense", "ragged")
N_PER = 256
NB_CAPS = dict(cand_leaf_cap=2048, cand_cap=8192, frontier_cap=256, run_cap=256)


def particles(n: int, n_per: int = N_PER):
    """(pos (n, 3), h (n,)) float32: JAX's dry-run particles, h scaled to
    keep the neighbours a particle at n above n_ranks x 256."""
    rng = np.random.RandomState(1)
    pos = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    return pos, np.full(n, 0.08 * (N_PER / n_per) ** (1 / 3), dtype=np.float32)


def _capacities(n: int, n_per: int, protocol: str) -> dict:
    """JAX's Domain capacities at 256 particles a rank of 8 (n = 2048),
    growing with the particle count n above it."""
    caps = dict(tree_capacity=max(4096, n // 2), focus_capacity=max(8192, n))
    if protocol == "ragged":  # totals per rank, not per-pair lane widths
        caps.update(treelet_cap=max(8192, n), halo_req_cap=max(4096, n // 2), halo_cap=max(8192, 2 * n_per))
    return caps


def brute_force_pairs(pos: np.ndarray, h: np.ndarray, rel: float = 0.0):
    """Ordered pairs i != j with |x_i - x_j|^2 < (2 h_i)^2 in float64, open
    box: the O(n^2) count, evaluated only over particle pairs in adjacent
    cells of side >= 2 max(h) (no pair within reach lies farther apart).
    With rel > 0, (the count at (2 h_i)^2 (1 - rel), the count, the count
    at (2 h_i)^2 (1 + rel)): the pairs a float32 evaluation of the same
    test may count lie between the first and the last."""
    X = pos.astype(np.float64)
    r2 = (2.0 * h.astype(np.float64)) ** 2
    side = 2.0 * float(h.max())
    lo = X.min(0)
    cell = np.floor((X - lo) / side).astype(np.int64)
    dims = cell.max(0) + 1
    cid = (cell[:, 0] * dims[1] + cell[:, 1]) * dims[2] + cell[:, 2]
    order = np.argsort(cid, kind="stable")
    cid_s = cid[order]
    factors = (1.0 - rel, 1.0, 1.0 + rel)
    total = [0, 0, 0]
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                nb = cell + (dx, dy, dz)
                ok = ((nb >= 0) & (nb < dims)).all(1)
                ncid = (nb[:, 0] * dims[1] + nb[:, 1]) * dims[2] + nb[:, 2]
                a = np.searchsorted(cid_s, ncid, side="left")
                b = np.where(ok, np.searchsorted(cid_s, ncid, side="right"), a)
                for c0 in range(0, X.shape[0], 1 << 16):  # bounded memory
                    i = np.arange(c0, min(c0 + (1 << 16), X.shape[0]))
                    cnt = b[i] - a[i]
                    ii = np.repeat(i, cnt)
                    start = np.repeat(a[i] - np.concatenate([[0], np.cumsum(cnt)[:-1]]), cnt)
                    jj = order[start + np.arange(ii.size)]
                    d2 = ((X[ii] - X[jj]) ** 2).sum(-1)
                    for k, f in enumerate(factors):
                        total[k] += int(((d2 < r2[ii] * f) & (ii != jj)).sum())
    return tuple(total) if rel > 0 else total[1]


def rank_step(comm, protocol: str, n_per: int = N_PER) -> dict:
    """One rank's sync and neighbour count (run by every rank, in order
    of the collectives); the rank's own numbers and the reductions."""
    from .domain import Domain
    from .ops import neighbors_v1, neighbors_v2, stencil
    from .traversal.neighbors import _find_neighbors_impl

    dev = comm.device
    R, r = comm.n_ranks, comm.rank
    pos, h = particles(n_per * R, n_per)
    cap = 8 * n_per

    def local(a):
        out = torch.zeros(cap, dtype=torch.float32, device=dev)
        out[:n_per] = torch.from_numpy(a[r * n_per:(r + 1) * n_per]).to(dev)
        return out

    for mod in (stencil, neighbors_v2, neighbors_v1):
        mod.reset_launches()
    t0 = time.perf_counter()
    domain = Domain(comm=comm, bucket_size=16, bucket_size_focus=8, key_dtype=np.uint64, protocol=protocol,
                    device=dev, **_capacities(R * n_per, n_per, protocol))
    state = domain.init_state()
    state, res = domain.sync(state, local(pos[:, 0]), local(pos[:, 1]), local(pos[:, 2]), local(h), n_local=n_per)
    view = domain.ns_view(res, state.box)
    j = torch.arange(cap, device=dev)
    owned = (j >= res.start_index) & (j < res.end_index)
    # only the owned slots' counts are summed. JAX makes every slot a
    # target; here the targets are the filled slots, the halo slots with
    # radius 0 (h 0), since a group that straddles the empty slots (at the
    # origin) or a jump between two halo leaves spans a region that grows
    # with the particle count (4 ranks of 16,384 on the CPU: a group
    # spanning half the box, 1,160 candidate leaves, a frontier of 716)
    counts, _, st = _find_neighbors_impl(
        res.x, res.y, res.z, torch.where(owned, res.h, 0.0), view, state.box, ng_max=1, group_size=16, chunk=8,
        with_indices=False, n_targets=int(res.n_with_halos), use_pallas="v2" if dev.type == "cuda" else False,
        **NB_CAPS)
    # a watermark AT its cap counts as overflow (JAX's check; the v2 route
    # reports runs and no flattened candidates, the plain route the reverse)
    watermarks = torch.stack([st.leaf_max, st.frontier_max, st.cand_max, st.run_max]).to(torch.int64)
    trav_ovf = (watermarks >= torch.tensor([NB_CAPS[k] for k in ("cand_leaf_cap", "frontier_cap", "cand_cap",
                                                                   "run_cap")], device=dev)).any()
    mine = torch.stack([torch.where(owned, counts.to(torch.int64), 0).sum(), res.end_index - res.start_index,
                        torch.ones((), dtype=torch.int64, device=dev)])
    total, n_assigned, alive = comm.all_reduce(mine, "sum").tolist()
    overflow = int(comm.all_reduce(torch.maximum(res.overflow, trav_ovf.to(res.overflow.dtype)), "max"))
    watermarks = comm.all_reduce(watermarks, "max").tolist()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return {"total": total, "n_assigned": n_assigned, "alive": alive, "overflow": overflow,
            "overflow_detail": res.overflow_detail.tolist(), "sync_and_count_ms": 1e3 * (time.perf_counter() - t0),
            "owned": int(res.end_index - res.start_index), "with_halos": int(res.n_with_halos),
            "traversal": dict(zip(("leaf_max", "frontier_max", "cand_max", "run_max"), watermarks)),
            "traversal_caps": NB_CAPS,
            "launches": {**stencil.launches(), **neighbors_v2.launches(), **neighbors_v1.launches()}}


def _both_protocols(comm, n_per: int) -> dict:
    return {p: rank_step(comm, p, n_per) for p in PROTOCOLS}


# float32 rounding of a pair's d2 and of (2h)^2, relative, with room: a
# pair within this band of its radius may count either way in float32
F32_BAND = 8 * 2.0 ** -24


def expected_sum(n_ranks: int, n_per: int):
    """The brute-force neighbour sum the run is held to: the exact float64
    count at JAX's 256 particles a rank (JAX's check); above it, where
    the float32 rounding of some of the many pairs at their radius moves
    them across it, the (lowest, float64, highest) counts of F32_BAND."""
    pos, h = particles(n_ranks * n_per, n_per)
    return brute_force_pairs(pos, h) if n_per <= N_PER else brute_force_pairs(pos, h, F32_BAND)


def check_run(out: dict, n_ranks: int, n_per: int, expected) -> None:
    """Raise unless rank 0's record of every protocol shows the ranks
    alive, overflow 0, every particle assigned and the brute-force sum
    (an int, or a (lowest, float64, highest) band, see expected_sum)."""
    n = n_ranks * n_per
    lo, _, hi = expected if isinstance(expected, tuple) else (expected,) * 3
    for p, o in out.items():
        if o["alive"] != n_ranks:
            raise RuntimeError(f"{p}: {o['alive']} ranks answered of {n_ranks}")
        if o["overflow"] != 0:
            raise RuntimeError(f"{p}: capacity overflow, detail {o['overflow_detail']} "
                               f"(local, tree, focus, move, treelet, halo, window), the neighbour pass's "
                               f"largest watermarks {o['traversal']} (caps {o['traversal_caps']})")
        if o["n_assigned"] != n:
            raise RuntimeError(f"{p}: assigned {o['n_assigned']} != {n}")
        if not lo <= o["total"] <= hi:
            raise RuntimeError(f"{p}: neighbour sum {o['total']} outside brute force {expected}")


def dryrun_multichip(n_ranks: int, device=None, backend: str = "gloo", n_per: int = N_PER,
                     timeout: float = 300.0, deadline: Optional[float] = 1800.0) -> list:
    """Spawn n_ranks rank processes (parallel/dist.spawn_ranks), run the
    dense then the ragged protocol in each, check both against brute
    force and return every rank's record (a dict per protocol). device:
    where the ranks run under gloo ("cuda", the default, or "cpu"); under
    nccl rank r takes cuda:r."""
    from .parallel.dist import spawn_ranks
    from .utils.device import resolve_device

    dev = resolve_device(device)
    out = spawn_ranks(n_ranks, _both_protocols, [n_per] * n_ranks, backend=backend, device=dev,
                      timeout=timeout, deadline=deadline)
    check_run(out[0], n_ranks, n_per, expected_sum(n_ranks, n_per))
    return out


# ---------------------------------------------------------------------------
# the steps mode
# ---------------------------------------------------------------------------

# (exchange_mode, protocol, first peer window) of each mode of the steps mode
STEP_MODES = {"pool": ("pool", "dense", 0), "dense": ("p2p", "dense", 0), "ragged": ("p2p", "ragged", 0),
              "window": ("p2p", "dense", 1)}
SEED, BUCKET, THETA = 42, 64, 0.5
WINDOW_TRIES = 4
SIM_DT, SIM_NG_MAX = 2e-3, 128


def default_h(n: int) -> float:
    """bench.py's default_h: h = 0.012 at 1M, scaled by n^-1/3, so that a
    particle keeps about 58 neighbours at any n."""
    return 0.012 * (1_000_000.0 / float(n)) ** (1.0 / 3.0)


def default_cell_cap(n: int, level: int, snapshots: int = 1) -> int:
    """bench.py's default_cell_cap: the ELL cap covering the Poisson
    occupancy tail over the cells and drift snapshots, a multiple of 64."""
    n_cells = float(1 << (3 * level)) * max(1, snapshots)
    mean = n / float(1 << (3 * level))
    cap = mean + math.sqrt(2.0 * math.log(n_cells) * mean) + 6.0
    return max(64, int(-(-cap // 64) * 64))


def tree_capacity(n: int, bucket: int = BUCKET) -> int:
    """bench.py's global tree capacity."""
    return max(4096, int(3.2 * n / bucket) // 1024 * 1024 + 4096)


def first_caps(n: int, n_ranks: int, bucket: int = BUCKET) -> dict:
    """The cold step's first capacities: a local buffer of the power of two
    above 2.05 x n / n_ranks (owned particles and their halos; 262,144 at
    125,000 a rank), bench.py's tree capacity for the global and the focus
    tree, the p2p capacities from the Domain's defaults (0)."""
    per = -(-n // n_ranks)
    tree = tree_capacity(n, bucket)
    return {"local": 1 << math.ceil(math.log2(2.05 * per)), "tree": tree, "focus": tree, "move": 0,
            "treelet": 0, "halo": 0}


def uniform_setup(n: int, device, seed: int = SEED) -> dict:
    """bench.py's sync_<n>_uniform sample on `device`: positions uniform in
    the periodic unit box, then the drift (uniform(-0.2, 0.2) x the mean
    spacing), both from one RandomState(seed); h = default_h(n), mass 1/n,
    the particle ids and the box."""
    from .sfc import PERIODIC, make_box

    dev = torch.device(device)
    rng = np.random.RandomState(seed)
    pos = rng.uniform(0.0, 1.0, size=(n, 3)).astype(np.float32)
    spacing = (1.0 / n) ** (1.0 / 3.0)
    drift = torch.from_numpy(rng.uniform(-0.2, 0.2, size=(n, 3)).astype(np.float32) * spacing).to(dev)
    return {"n": n, "xyz": tuple(torch.from_numpy(np.ascontiguousarray(pos[:, i])).to(dev) for i in range(3)),
            "drift": drift, "h": torch.full((n,), default_h(n), dtype=torch.float32, device=dev),
            "m": torch.full((n,), 1.0 / n, dtype=torch.float32, device=dev), "ids": torch.arange(n, device=dev),
            "box": make_box(0.0, 1.0, boundaries=PERIODIC, device=dev)}


def _drain(dev) -> None:
    """Wait for the work queued on dev's current stream (nothing on the CPU)."""
    if torch.device(dev).type == "cuda":
        torch.cuda.current_stream(dev).synchronize()


def _stamp(dev):
    """A time mark: a CUDA event recorded on dev's stream, or the host clock."""
    if torch.device(dev).type != "cuda":
        return time.perf_counter()
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(dev))
    return ev


def _ms(a, b) -> float:
    """Milliseconds between two marks of _stamp."""
    if isinstance(a, float):
        return 1e3 * (b - a)
    b.synchronize()
    return a.elapsed_time(b)


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


class CallTimer:
    """Sums the ms of module.name's calls inside the block on the host
    clock, the current CUDA stream drained before and after each call, so
    that a call's time holds its own kernels. It patches the module: use
    it in a process whose rank runs on one thread, not from run_ranks'
    threads."""

    def __init__(self, module, name):
        self.module, self.name, self.ms = module, name, 0.0

    def __enter__(self):
        self.real = getattr(self.module, self.name)

        def timed(*a, **k):
            cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
            if cuda:
                torch.cuda.current_stream().synchronize()
            t0 = time.perf_counter()
            try:
                return self.real(*a, **k)
            finally:
                if cuda:
                    torch.cuda.current_stream().synchronize()
                self.ms += 1e3 * (time.perf_counter() - t0)

        setattr(self.module, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def rank_input(setup: dict, r: int, n_ranks: int, cap: int) -> dict:
    """Rank r of n_ranks starts from the strided slice r::n_ranks of every
    field, padded to cap: the exchange moves nearly every particle."""

    def pad(a, fill):
        out = torch.full((cap,), fill, dtype=a.dtype, device=a.device)
        s = a[r::n_ranks]
        out[:s.numel()] = s
        return out

    ids = setup["ids"]
    return {"xyz": tuple(pad(c, 0.0) for c in setup["xyz"]), "h": pad(setup["h"], 0.0), "m": pad(setup["m"], 0.0),
            "ids": pad(ids, -1), "n": torch.tensor(ids[r::n_ranks].numel(), device=ids.device)}


def drift_input(inp: dict, drift, sgn: float) -> dict:
    """A rank's next input: its particles moved by the drift of their ids."""
    return dict(inp, xyz=tuple((c + sgn * drift[inp["ids"].clamp(min=0), i]) % 1.0
                               for i, c in enumerate(inp["xyz"])))


def make_domain(comm, caps: dict, mode: str, protocol: str, device, window: int = 0, bucket: int = BUCKET,
                theta: float = THETA):
    """A rank's Domain; the p2p capacities 0 take the Domain's defaults,
    and "halo" is both the request and the particle capacity; `window`
    is the dense protocol's peer window (0: none)."""
    from .domain import Domain

    return Domain(bucket_size=bucket, tree_capacity=caps["tree"], focus_capacity=caps["focus"], theta=theta,
                  exchange_mode=mode, protocol=protocol, comm=comm, device=device, move_cap=caps["move"],
                  treelet_cap=caps["treelet"], halo_req_cap=caps["halo"], halo_cap=caps["halo"], peer_window=window)


def rank_sync(comm, domain, state, inp: dict):
    """One rank's sync between two barriers: (state, res, (start, end))
    on the host clock, the rank's stream drained."""
    comm.all_reduce_flag(True)  # start together
    t0 = time.perf_counter()
    state, res = domain.sync(state, *inp["xyz"], inp["h"], properties=(inp["m"],), n_local=inp["n"])
    _drain(res.x.device)
    return state, res, (t0, time.perf_counter())


def rank_after(comm, domain, state, res, inp: dict, level: int, cap: int) -> dict:
    """B1 and B2 on the rank's buffer, the ids of its slots (p2p: the
    owned ones, halo slots 0), the ids exchange_halos puts into the halo
    slots, the next step's input (the owned particles, by compact_owned)
    and the time marks around B1 and B2 ("marks")."""
    from .traversal import cell_list_neighbor_counts, cell_list_sph_density

    dev = res.x.device
    rid = domain.reapply_sync(res, inp["ids"])
    t0 = _stamp(dev)
    counts, c_ovf = cell_list_neighbor_counts(res.keys, res.x, res.y, res.z, res.h, state.box, level, cap,
                                              n_valid=res.n_with_halos, impl="pallas")
    t1 = _stamp(dev)
    rho, d_ovf = cell_list_sph_density(res.keys, res.x, res.y, res.z, res.h, state.box, level, cap,
                                       mass=res.properties[0], n_valid=res.n_with_halos)
    t2 = _stamp(dev)
    j = torch.arange(rid.shape[0], device=dev)
    owned = (j >= res.start_index) & (j < res.end_index)
    halo_ids = domain.exchange_halos(res, torch.where(owned, rid, -1))
    co = domain.compact_owned
    nxt = {"xyz": tuple(co(res, c) for c in (res.x, res.y, res.z)), "h": co(res, res.h),
           "m": co(res, res.properties[0]), "ids": co(res, rid), "n": res.end_index - res.start_index}
    return {"rid": rid, "counts": counts, "rho": rho, "halo_ids": halo_ids,
            "cell_ovf": bool(c_ovf | d_ovf), "next": nxt, "marks": (t0, t1, t2)}


def window_need(domain, state, res) -> int:
    """What overflow_detail[6] must say for one rank: the largest rank
    offset of its halo leaves' owners and of its MAC peers (diagnostics'
    mac_peer_max_offset), where that exceeds the window; else 0."""
    from .ops.primitives import searchsorted

    n_leaf = int(res.tree.n_leaf)
    owner = torch.clamp(searchsorted(state.assignment.boundaries, res.tree.leaves[:n_leaf], side="right") - 1,
                        0, domain.n_ranks - 1)
    halo = res.halo_flags[:n_leaf].bool()
    off = int((owner[halo] - domain.rank).abs().max()) if bool(halo.any()) else 0
    need = max(off, domain.diagnostics(state, res)["mac_peer_max_offset"])
    return need if need > domain.peer_window else 0


def cold_try(comm, setup: dict, caps: dict, mode: str, protocol: str, window: int = 0, bucket: int = BUCKET,
             theta: float = THETA):
    """One try of the cold step on one rank: a fresh Domain and state,
    the rank's strided input at caps["local"], one sync. Returns (state,
    res, span, input, domain, the comm's RankTally, reset before the
    sync)."""
    tally = RankTally.of(comm)
    tally.reset()
    domain = make_domain(comm, caps, mode, protocol, setup["ids"].device, window, bucket, theta)
    state = domain.init_state(box=setup["box"], boundaries=(1, 1, 1))
    inp = rank_input(setup, comm.rank, comm.n_ranks, caps["local"])
    state, res, span = rank_sync(comm, domain, state, inp)
    return state, res, span, inp, domain, tally


@dataclass
class ColdStep:
    """A rank's converged cold step: its last try's state, result, span,
    input and Domain, the capacities and the comm's tally, and every try's
    (window, overflow_detail, ms in find_peers_mac)."""
    state: object
    res: object
    span: tuple
    inp: dict
    domain: object
    caps: dict
    tally: RankTally
    tries: list


def cold_step(comm, setup: dict, caps: dict, mode: str, protocol: str, window: int = 0, bucket: int = BUCKET,
              theta: float = THETA, peers_ms: Callable[[], float] = lambda: 0.0,
              tries: int = WINDOW_TRIES) -> ColdStep:
    """The cold step on one rank, run by every rank: cold_try until no
    overflow. Every rank sees the largest overflow of all ranks and so
    takes the same retry: a capacity named by overflow_detail grows as
    sync_with_retry grows it, and the peer window (window > 0) to
    overflow_detail[6], the rank offset the halo owners and MAC peers
    need. In window mode every try's halo record must hold 2W+1 rows and
    overflow_detail[6] must equal the largest window_need of all ranks;
    raises otherwise, or after `tries` retries."""
    from .domain import CAP_NAMES

    caps, history = dict(caps), []
    dev = setup["ids"].device
    for _ in range(tries + 1):
        p0 = peers_ms()
        state, res, span, inp, domain, tally = cold_try(comm, setup, caps, mode, protocol, window, bucket, theta)
        detail = res.overflow_detail.tolist()
        history.append((window, detail, peers_ms() - p0))
        if window:
            rec = res.halo_record
            w = domain.peer_window
            if rec.window != w or rec.send_idx.shape[0] != 2 * w + 1:
                raise RuntimeError(f"rank {comm.rank}, W={w}: a halo record of window {rec.window}, "
                                   f"{rec.send_idx.shape[0]} rows")
            need = int(comm.all_reduce(torch.tensor(window_need(domain, state, res), device=dev), "max"))
            if detail[6] != need:
                raise RuntimeError(f"rank {comm.rank}, W={w}: overflow_detail[6] is {detail[6]}, the halo owners "
                                   f"and MAC peers need {need}")
        if int(res.overflow) == 0:
            return ColdStep(state, res, span, inp, domain, caps, tally, history)
        for i, name in enumerate(CAP_NAMES[:6]):  # sync_with_retry's growth
            if detail[i] > 0:
                caps[name] = max(int(caps.get(name, 0) * 1.6) + 8, int(detail[i]) + 8)
        if detail[6] > window:
            window = detail[6]
        elif not any(detail[:6]):
            raise RuntimeError(f"an overflow without a capacity or window report: {history}")
    raise RuntimeError(f"the cold step still overflows after {tries} retries: caps {caps}, tries {history}")


def _kernel_launches() -> dict:
    from .ops import neighbors_v1, neighbors_v2, sfc_codec, stencil

    return {**stencil.launches(), **neighbors_v2.launches(), **neighbors_v1.launches(),
            **{f"sfc_{k}": v for k, v in sfc_codec.launches().items()}}


def hold_to_plain(calls, what: str) -> dict:
    """Every recorded launch (record_launches) against its plain version on
    the same arguments: counts bit-equal, densities within rtol 1e-5
    (float atomics). Raises on a difference; returns the largest |kernel -
    plain| of each kernel."""
    from .ops import neighbors_v1, neighbors_v2, stencil

    err = {}
    for name, args, got in calls:
        mod = {"pairwise_count_runs": neighbors_v2, "pairwise_count": neighbors_v1}.get(name, stencil)
        want = getattr(mod, name + "_plain")(*args)
        if name.endswith("density"):
            ok = torch.allclose(got, want, rtol=1e-5, atol=1e-6)
            gap = float((got - want).abs().max()) if got.numel() else 0.0
        else:
            ok = torch.equal(got, want)
            gap = float((got.long() - want.long()).abs().max()) if got.numel() else 0.0
        if not ok:
            raise RuntimeError(f"{name} differs from its plain version ({what}): largest gap {gap}")
        err[name] = max(err.get(name, 0.0), gap)
    return err


def slot_record(state, res, after: dict) -> dict:
    """What one mode is held to of another at the same rank and step: the
    global tree, the assignment, the focus leaves with their halo flags
    and layout (over the leaves: the modes' cold steps may grow the focus
    capacity apart), the owned range and, over the buffer's filled slots,
    the keys, the ids exchange_halos puts there, the B1 counts and the B2
    densities."""
    t, nwh, n_leaf = state.global_tree, int(res.n_with_halos), int(res.tree.n_leaf)
    nn = int(t.n_nodes)
    return {"tree_keys": t.keys[:nn + 1], "tree_counts": t.counts[:nn], "boundaries": state.assignment.boundaries,
            "leaves": res.tree.leaves[:n_leaf + 1], "halo_flags": res.halo_flags[:n_leaf],
            "layout": res.layout[:n_leaf + 1], "start": int(res.start_index), "end": int(res.end_index),
            "n_with_halos": nwh,
            "keys": res.keys[:nwh], "halo_ids": after["halo_ids"][:nwh], "counts": after["counts"][:nwh],
            "rho": after["rho"][:nwh]}


def hold_to_mode(what: str, want: dict, got: dict, ref: str) -> None:
    """One mode's slot_record against another's: all bit-equal but the
    densities, within rtol 1e-5. Raises on a difference, naming every
    field that differs, where and how often."""
    bad = []
    for k, v in want.items():
        if k == "rho":
            ok = v.shape == got[k].shape and torch.allclose(v, got[k], rtol=1e-5, atol=0.0)
        elif isinstance(v, torch.Tensor):
            ok = v.shape == got[k].shape and torch.equal(v, got[k])
        else:
            ok = v == got[k]
        if ok:
            continue
        if isinstance(v, torch.Tensor) and v.shape == got[k].shape:
            at = torch.nonzero(v != got[k])[:, 0]
            bad.append(f"{k} at {at.numel()} of {v.numel()} entries, the first {at[:4].tolist()}")
        else:
            bad.append(f"{k} ({v if not isinstance(v, torch.Tensor) else tuple(v.shape)} against "
                       f"{got[k] if not isinstance(got[k], torch.Tensor) else tuple(got[k].shape)})")
    if bad:
        raise RuntimeError(f"{what}: differs from {ref}'s in " + "; ".join(bad)
                           + f" (focus leaves {want['leaves'].numel() - 1})")


def hold_to_reference(comm, what: str, ref: dict, setup: dict, state, res, after: dict, pool: bool) -> dict:
    """One rank's step against the one-rank reference of the same step,
    run by every rank (two reductions): overflow 0; the global tree
    bit-equal; the owned keys inside the rank's range; exchange_halos' ids
    in every filled slot those of the particles there (the reference's
    positions by id equal the slot's; pool: also reapply_sync's ids); B1
    counts by particle id bit-equal, B2 densities within rtol 1e-5; every
    particle owned by exactly one rank; the mean neighbour count 57.9 +-
    0.5 and the mean density within 2% of 1 + 1/(pi h^3 n). Raises on a
    failure; returns the largest relative density gap, the means."""
    from .ops.keys64 import ule, ult

    n, r = setup["n"], comm.rank
    dev = setup["ids"].device
    fails = []
    if int(res.overflow) != 0 or after["cell_ovf"]:
        fails.append(f"overflow {res.overflow_detail.tolist()}, cell overflow {after['cell_ovf']}")
    t, (ref_keys, ref_counts) = state.global_tree, ref["tree"]
    nn = int(t.n_nodes)
    if not (nn + 1 == ref_keys.numel() and torch.equal(t.keys[:nn + 1], ref_keys)
            and torch.equal(t.counts[:nn], ref_counts)):
        fails.append("the global tree differs from the one-rank run's")
    s, e, nwh = int(res.start_index), int(res.end_index), int(res.n_with_halos)
    bnd = state.assignment.boundaries
    keys = res.keys[s:e]
    if not bool((ule(bnd[r], keys) & ult(keys, bnd[r + 1])).all()):
        fails.append("an owned key lies outside the rank's range")
    rid, hid = after["rid"], after["halo_ids"]
    own = rid[s:e]
    hid_ok = bool((hid[:nwh] >= 0).all()) and torch.equal(hid[s:e], own) and (not pool or torch.equal(hid[:nwh], rid[:nwh]))
    if hid_ok:
        sel = hid[:nwh]
        hid_ok = all(torch.equal(rc[sel], c[:nwh]) for rc, c in zip(ref["xyz"], (res.x, res.y, res.z)))
    if not hid_ok:
        fails.append("exchange_halos did not put the ids of the particles in the slots into them")
    counts, rho = after["counts"][s:e], after["rho"][s:e]
    if not torch.equal(counts, ref["counts"][own]):
        fails.append(f"B1 counts differ from the one-rank run's at {int((counts != ref['counts'][own]).sum())} "
                     "particles")
    ref_rho = ref["rho"][own]
    gap = float(((rho - ref_rho).abs() / ref_rho).max()) if own.numel() else 0.0
    if not torch.allclose(rho, ref_rho, rtol=1e-5, atol=0.0):
        fails.append(f"B2 densities differ from the one-rank run's beyond rtol 1e-5 (max rel {gap})")
    owners = comm.all_reduce(torch.zeros(n, dtype=torch.int32, device=dev).index_add_(
        0, own, torch.ones_like(own, dtype=torch.int32)), "sum")
    sums = comm.all_reduce(torch.stack([counts.double().sum(), rho.double().sum()]), "sum").tolist()
    if not bool((owners == 1).all()):
        fails.append(f"the owned ranges are not a partition of the {n} particles "
                     f"({int((owners != 1).sum())} owned other than once)")
    mean_nb, mean_rho = sums[0] / n, sums[1] / n
    h = float(setup["h"][0])
    expect_rho = 1.0 + 1.0 / (math.pi * h ** 3 * n)
    if abs(mean_nb - 57.9) > 0.5 or abs(mean_rho / expect_rho - 1.0) > 0.02:
        fails.append(f"mean neighbours {mean_nb} (57.9 +- 0.5), mean density {mean_rho} ({expect_rho} +- 2%)")
    if fails:
        raise RuntimeError(f"{what}, rank {r}: " + "; ".join(fails))
    return {"rho_gap": gap, "mean_neighbours": mean_nb, "mean_density": mean_rho}


def reference_steps(setup: dict, steps: int, level: int, cap: int, tree_cap: int, bucket: int = BUCKET,
                    timed_steps: int = 0):
    """The one-rank run of the same particles and steps (bench.py's
    sync_<n>_uniform: Domain(comm=None), sync_with_retry on the tree
    capacity, B1, then B2), on setup's device. Returns (per step of the
    cold step and `steps` drift steps: the global tree, the B1 counts and
    B2 densities by particle id, the input positions (by id); the ms of
    sync + B1 and of B2 a step, over max(steps, timed_steps) drift steps
    after the cold step)."""
    from .domain import Domain, sync_with_retry
    from .traversal import cell_list_neighbor_counts, cell_list_sph_density

    n, dev = setup["n"], setup["ids"].device

    def step(domain, state, xyz):
        t0 = _stamp(dev)
        state, res = domain.sync(state, *xyz, setup["h"], properties=(setup["m"],))
        counts, c_ovf = cell_list_neighbor_counts(res.keys, res.x, res.y, res.z, res.h, state.box, level, cap,
                                                  n_valid=res.n_with_halos, impl="pallas")
        t1 = _stamp(dev)
        rho, d_ovf = cell_list_sph_density(res.keys, res.x, res.y, res.z, res.h, state.box, level, cap,
                                           mass=res.properties[0], n_valid=res.n_with_halos)
        t2 = _stamp(dev)
        if bool(c_ovf | d_ovf):
            raise RuntimeError(f"the one-rank reference: the cell list's cap {cap} overflowed")
        return state, counts, rho, (t0, t1, t2), res

    def cold(caps):
        domain = Domain(bucket_size=bucket, tree_capacity=caps["tree"], device=dev)
        return (domain,) + step(domain, domain.init_state(box=setup["box"], boundaries=(1, 1, 1)), xyz)

    xyz = setup["xyz"]
    (domain, state, counts, rho, marks, res), _ = sync_with_retry(cold, {"tree": tree_cap})
    out, ms = [], {"sync_counts_ms": [], "density_ms": []}
    sgn = 1.0
    for i in range(1 + max(steps, timed_steps)):
        if i:
            xyz = tuple((c + sgn * setup["drift"][:, k]) % 1.0 for k, c in enumerate(xyz))
            sgn = -sgn
            state, counts, rho, marks, res = step(domain, state, xyz)
            if int(res.overflow):
                raise RuntimeError(f"the one-rank reference overflows: {res.overflow_detail.tolist()}")
        ms["sync_counts_ms"].append(_ms(marks[0], marks[1]))
        ms["density_ms"].append(_ms(marks[1], marks[2]))
        if i <= steps:
            by_id = lambda v: torch.empty_like(v[:n]).index_copy_(0, res.sort_order[:n], v[:n])  # noqa: E731
            t = state.global_tree
            nn = int(t.n_nodes)
            out.append({"tree": (t.keys[:nn + 1].clone(), t.counts[:nn].clone()), "counts": by_id(counts),
                        "rho": by_id(rho), "xyz": xyz})
    return out, ms


def rank_steps(comm, setup: dict, mode: str, protocol: str, window: int, steps: int, level: int, cap: int,
               caps: dict, reference: Optional[list] = None, on_step: Optional[Callable] = None,
               bucket: int = BUCKET, theta: float = THETA, peers: Optional[CallTimer] = None) -> dict:
    """One rank's timestep in one mode, run by every rank: the cold step
    (cold_step: the capacity retry on the largest overflow of all ranks;
    with window > 0 the window grown from `window` by overflow_detail[6]),
    then `steps` drift steps fed by compact_owned; after each sync, B1 and
    B2 on the rank's buffer (rank_after). With a `reference`
    (reference_steps' records) every step is held to it
    (hold_to_reference); on the card every B1/B2 launch of the last step
    is held to its plain version (hold_to_plain). `on_step(state, res,
    after, span, comm rounds)` is called after each step, its results
    kept. `peers`: a CallTimer of find_peers_mac, read around each sync.

    Returns the converged capacities, window and tries, per step the
    span, the ms of the sync (host clock, the stream drained), of B1's
    and B2's calls (CUDA events) and in find_peers_mac, the comm's rounds
    and bytes (RankTally), the owned and buffered particles, the overflow
    detail and hold_to_reference's numbers; per step slot_record's tensors
    ("records") and on_step's results ("extra"); the kernel launches
    counted in the run; the last step's launched kernels and their largest
    gaps to plain; the peak memory allocated on the card (None on the
    CPU)."""
    from .ops.cuda_lib import record_launches

    dev = setup["ids"].device
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    peers_ms = (lambda: peers.ms) if peers is not None else (lambda: 0.0)
    before = _kernel_launches()
    cold = cold_step(comm, setup, caps, mode, protocol, window, bucket, theta, peers_ms)
    state, res, span, inp, domain, tally = cold.state, cold.res, cold.span, cold.inp, cold.domain, cold.tally
    name = mode if mode == "pool" else (protocol if not window else "window")
    numbers, records, extra, sgn = [], [], [], 1.0
    calls = []
    for step in range(1 + steps):
        p_ms = cold.tries[-1][2]
        if step:
            inp = drift_input(inp, setup["drift"], sgn)
            sgn = -sgn
            tally.reset()
            p0 = peers_ms()
            state, res, span = rank_sync(comm, domain, state, inp)
            p_ms = peers_ms() - p0
        stats = tally.read()  # the sync's rounds, before exchange_halos'
        if getattr(comm, "backend", None) == "nccl" and stats["staged_bytes"]:
            raise RuntimeError(f"{name}, rank {comm.rank}: {stats['staged_bytes']} bytes staged through host "
                               "memory under nccl")
        with (record_launches() if cuda and step == steps else contextlib.nullcontext([])) as calls:
            after = rank_after(comm, domain, state, res, inp, level, cap)
        t0, t1, t2 = after["marks"]
        rec = {"span": span, "sync_ms": 1e3 * (span[1] - span[0]), "counts_ms": _ms(t0, t1),
               "density_ms": _ms(t1, t2), "peers_ms": p_ms, "comm": stats,
               "owned": int(res.end_index - res.start_index), "with_halos": int(res.n_with_halos),
               "overflow_detail": res.overflow_detail.tolist()}
        if reference is not None:
            what = f"{name}, " + ("cold step" if step == 0 else f"drift step {step}")
            rec.update(hold_to_reference(comm, what, reference[step], setup, state, res, after, mode == "pool"))
        numbers.append(rec)
        records.append(slot_record(state, res, after))
        if on_step is not None:
            extra.append(on_step(state, res, after, span, stats))
        inp = after["next"]
    now = _kernel_launches()
    launches = {k: now[k] - before.get(k, 0) for k in now}
    peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    launched = sorted(c[0] for c in calls)
    if cuda and launched != ["stencil_counts", "stencil_density"]:
        raise RuntimeError(f"{name}, rank {comm.rank}: the last step launched {launched}")
    err = hold_to_plain(calls, f"{name}, rank {comm.rank}, the last step")
    return {"caps": cold.caps, "window": domain.peer_window, "tries": [t[:2] for t in cold.tries],
            "tries_peers_ms": [t[2] for t in cold.tries], "steps": numbers, "records": records, "extra": extra,
            "launches": launches, "last_launched": launched, "plain_err": err, "peak": peak}


def run_modes(comm, setup: dict, modes, steps: int, level: int, cap: int, caps: dict,
              reference: Optional[list] = None, bucket: int = BUCKET, theta: float = THETA,
              peers: Optional[CallTimer] = None) -> dict:
    """rank_steps in each of `modes` (names of STEP_MODES) in turn, in its
    own Domains, every mode held at every step to the first mode's
    slot_record (hold_to_mode); rank 0 prints each mode's end. Returns
    rank_steps' numbers by mode, without the records."""
    first, out = None, {}
    for name in modes:
        t0 = time.perf_counter()
        mode, protocol, window = STEP_MODES[name]
        got = rank_steps(comm, setup, mode, protocol, window, steps, level, cap, caps, reference, None, bucket,
                         theta, peers)
        if first is None:
            first = (name, got["records"])
        else:
            for step, (want, rec) in enumerate(zip(first[1], got["records"])):
                hold_to_mode(f"{name}, step {step}, rank {comm.rank}", want, rec, first[0])
        out[name] = {k: v for k, v in got.items() if k not in ("records", "extra")}
        if comm.rank == 0:
            print(f"rank 0: mode {name} held to the reference" + (f" and to {first[0]}" if first[0] != name else "")
                  + f" in {time.perf_counter() - t0:.3f} s", flush=True)
    return out


def sim_velocities(n: int, device, seed: int = SEED):
    """Velocities normal(0, 0.05) from RandomState(seed), minus their
    mean: ((vx, vy, vz) on device, sum |v|)."""
    vel = np.random.RandomState(seed).normal(0.0, 0.05, size=(n, 3)).astype(np.float32)
    vel -= vel.mean(axis=0, keepdims=True)
    return tuple(torch.from_numpy(np.ascontiguousarray(vel[:, i])).to(device) for i in range(3)), \
        float(np.abs(vel).sum())


def sim_steps(comm, setup: dict, vel, caps: dict, steps: int, ng_max: int = SIM_NG_MAX,
              bucket: int = BUCKET, theta: float = THETA, nb: Optional[CallTimer] = None) -> list:
    """models/simulation's loop: sim_init and a cold step plus `steps`
    sim_steps at dt SIM_DT. comm None: one rank of all n particles (tree
    capacity caps["tree"]); else rank comm.rank of the dense p2p Domain
    from the strided slice r::R. A step that overflows raises (on every
    rank: sim_step's overflow is the largest of all ranks), since the
    next would run on a truncated tree. Per step (energy, momentum,
    overflow, owned, ms on the host clock with the stream drained, ms in
    find_neighbors by `nb`)."""
    from .domain import Domain
    from .models import sim_init, sim_step

    dev, n = setup["ids"].device, setup["n"]
    if comm is None:
        domain, r, R, cap = Domain(bucket_size=bucket, tree_capacity=caps["tree"], device=dev), 0, 1, n
    else:
        domain = make_domain(comm, caps, "p2p", "dense", dev, 0, bucket, theta)
        r, R, cap = comm.rank, comm.n_ranks, caps["local"]

    def part(a):
        out = torch.zeros(cap, dtype=a.dtype, device=dev)
        s = a[r::R]
        out[:s.numel()] = s
        return out

    state = sim_init(domain.init_state(box=setup["box"], boundaries=(1, 1, 1)), *(part(c) for c in setup["xyz"]),
                     part(setup["h"]), *(part(v) for v in vel), setup["ids"][r::R].numel())
    out = []
    for _ in range(1 + steps):
        if comm is not None:
            comm.all_reduce_flag(True)  # start together
        nb0 = nb.ms if nb is not None else 0.0
        t0 = time.perf_counter()
        state, e, p, ovf = sim_step(domain, state, SIM_DT, ng_max=ng_max)
        _drain(dev)
        t1 = time.perf_counter()
        out.append({"energy": float(e), "momentum": p.cpu(), "overflow": int(ovf), "owned": int(state.n_local),
                    "span": (t0, t1), "ms": 1e3 * (t1 - t0), "nb_ms": (nb.ms if nb is not None else 0.0) - nb0})
        if out[-1]["overflow"]:
            raise RuntimeError(f"the simulation loop ({'one rank' if comm is None else f'rank {r} of {R}'}) "
                               f"overflows at step {len(out) - 1} with capacities {caps}, ng_max {ng_max}")
    return out


def hold_sim(comm, got: list, want: list, n: int, v_abs: float) -> dict:
    """The ranks' simulation steps against the one-rank run's: overflow 0,
    the owned particles summing to n, energy within 1e-4 of |E| and
    momentum within 1e-6 x sum |v| at every step (path I's tolerances).
    Raises otherwise; returns the largest gaps."""
    owned = comm.all_reduce(torch.tensor([g["owned"] for g in got], device=comm.device), "sum").tolist()
    e_gap = max(abs(g["energy"] - w["energy"]) / abs(w["energy"]) for g, w in zip(got, want))
    p_gap = max(float((g["momentum"] - w["momentum"]).abs().max()) for g, w in zip(got, want))
    fails = [f"overflow at step {i}" for i, g in enumerate(got) if g["overflow"] or want[i]["overflow"]]
    fails += [f"owned {o} != {n} at step {i}" for i, o in enumerate(owned) if o != n]
    if e_gap > 1e-4:
        fails.append(f"energy {e_gap} of |E| from the one-rank run (tolerance 1e-4)")
    if p_gap > 1e-6 * v_abs:
        fails.append(f"momentum {p_gap} from the one-rank run (tolerance 1e-6 x sum |v| = {1e-6 * v_abs})")
    if fails:
        raise RuntimeError(f"the simulation loop, rank {comm.rank}: " + "; ".join(fails))
    return {"energy_gap": e_gap, "momentum_gap": p_gap, "tolerance_momentum": 1e-6 * v_abs}


def _libraries() -> tuple:
    """The kernel libraries of the steps mode (B1/B2) and the dry run (B5)."""
    from .ops import neighbors_v2, stencil

    return stencil.SYM_LIBRARY, neighbors_v2.LIBRARY


def load_kernels(comm, leader: bool) -> list:
    """Build the steps mode's and the dry run's kernel libraries (B1/B2
    and B5) once a host: the leader (local rank 0) builds them, in
    parallel, before every rank meets at one flag; the others then load
    the built files. A failed build raises on the leader and, through the
    flag, on every rank. Returns the names of the sources built here."""
    from concurrent.futures import ThreadPoolExecutor

    libs = _libraries()
    error = None
    if leader:
        try:
            with ThreadPoolExecutor(len(libs)) as pool:
                list(pool.map(lambda lib: lib.load(), libs))
        except Exception as e:  # reported to every rank below, then raised here
            error = e
    if not comm.all_reduce_flag(error is None):
        if error is not None:
            raise error
        raise RuntimeError("the leader rank failed to build the kernels")
    for lib in libs:
        lib.load()
    return [lib.source.name for lib in libs if lib.build_log]


def steps_config(n: int, n_ranks: int, steps: int, modes, sim_steps: int = 2, timed_steps: int = 10) -> dict:
    """Everything the ranks of the steps mode share: the sizes (see the
    module docstring) and what to run."""
    from .sfc import PERIODIC, make_box
    from .traversal import choose_cell_level

    level = choose_cell_level(make_box(0.0, 1.0, boundaries=PERIODIC, device="cpu"), default_h(n))
    for m in modes:
        if m not in STEP_MODES:
            raise ValueError(f"unknown mode {m!r}; the modes are {sorted(STEP_MODES)}")
    return {"n": n, "ranks": n_ranks, "steps": steps, "modes": list(modes), "sim_steps": sim_steps,
            "level": level, "cell_cap": default_cell_cap(n, level, snapshots=3), "h": default_h(n),
            "caps": first_caps(n, n_ranks), "timed_steps": timed_steps}


def steps_rank(comm, cfg: dict) -> dict:
    """One rank of the steps mode (every rank runs it): the one-rank
    reference on the rank's own device, then every mode by run_modes,
    held to it and to each other. Returns the rank's numbers (no
    tensors)."""
    from .domain import domain as domain_module

    dev = comm.device
    setup = uniform_setup(cfg["n"], dev)
    t0 = time.perf_counter()
    ref, ref_ms = reference_steps(setup, cfg["steps"], cfg["level"], cfg["cell_cap"], cfg["caps"]["tree"],
                                  timed_steps=cfg["timed_steps"])
    out = {"rank": comm.rank, "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
           "reference": dict(ref_ms, seconds=time.perf_counter() - t0)}
    if comm.rank == 0:
        print(f"rank 0: the one-rank reference took {out['reference']['seconds']:.3f} s", flush=True)
    with CallTimer(domain_module, "find_peers_mac") as peers:
        out["modes"] = run_modes(comm, setup, cfg["modes"], cfg["steps"], cfg["level"], cfg["cell_cap"],
                                 cfg["caps"], ref, peers=peers)
    out["seconds"] = time.perf_counter() - t0
    return out


def sim_rank(comm, cfg: dict, caps: dict) -> dict:
    """One rank of the steps mode's simulation loop (every rank runs it):
    the one-rank run of all n particles on the rank's own device, then
    the ranks' run, held to it (hold_sim); `caps`: the capacities a
    mode's cold step grew to (the first ones overflow at 4M)."""
    from .models import simulation

    setup = uniform_setup(cfg["n"], comm.device)
    vel, v_abs = sim_velocities(cfg["n"], comm.device)
    with CallTimer(simulation, "_find_neighbors_impl") as nb:
        one = sim_steps(None, setup, vel, caps, cfg["sim_steps"], nb=nb)
        got = sim_steps(comm, setup, vel, caps, cfg["sim_steps"], nb=nb)
    return {"one_rank": one, "ranks": got, "caps": caps, **hold_sim(comm, got, one, cfg["n"], v_abs)}


def sim_caps(rec: dict) -> dict:
    """The capacities the simulation loop takes: those the dense mode's
    cold step grew to, else the first mode's."""
    return rec["modes"].get("dense", next(iter(rec["modes"].values())))["caps"]


def spawned_rank(comm, cfg: dict) -> dict:
    """A rank process of the spawned steps mode: steps_rank, then
    sim_rank."""
    rec = steps_rank(comm, cfg)
    if cfg["sim_steps"]:
        rec["sim"] = sim_rank(comm, cfg, sim_caps(rec))
    return rec


def _fmt(xs) -> str:
    return json.dumps([round(x, 3) for x in xs])


def report_steps(recs: list, cfg: dict, backend: str, seconds: float) -> dict:
    """Print the steps mode's lines from every rank's steps_rank record;
    returns the summary that the last line prints as JSON."""
    R = len(recs)
    summary = {"mode": "steps", "ranks": R, "backend": backend, "devices": [r["device"] for r in recs],
               **{k: cfg[k] for k in ("n", "steps", "level", "cell_cap", "h", "caps")}, "modes": {}}
    ref = recs[0]["reference"]
    med = float(np.median(ref["sync_counts_ms"][1:])) if len(ref["sync_counts_ms"]) > 1 else None
    print(f"one-rank reference, {cfg['n']} particles on each rank's {recs[0]['device']}: sync+B1 ms a step "
          f"(cold, then drift) {_fmt(ref['sync_counts_ms'])}, median of the drift steps {med}; B2 ms "
          f"{_fmt(ref['density_ms'])}", flush=True)
    summary["reference"] = {"sync_counts_ms": ref["sync_counts_ms"], "density_ms": ref["density_ms"],
                            "sync_counts_median_ms": med,
                            "per_rank_median_ms": [float(np.median(r["reference"]["sync_counts_ms"][1:]))
                                                   if len(ref["sync_counts_ms"]) > 1 else None for r in recs]}
    for name in cfg["modes"]:
        per = [r["modes"][name] for r in recs]
        m = {"window": per[0]["window"], "tries": per[0]["tries"], "caps": per[0]["caps"],
             "peak_bytes": [p["peak"] for p in per], "launches": [p["launches"] for p in per],
             "plain_err": [p["plain_err"] for p in per], "steps": []}
        if name == "window":
            print(f"{name}: W grew {' -> '.join(str(w) for w, _ in per[0]['tries'])}; find_peers_mac ms of the "
                  f"cold tries per rank {json.dumps([[round(x, 3) for x in p['tries_peers_ms']] for p in per])}",
                  flush=True)
        for step in range(1 + cfg["steps"]):
            s = [p["steps"][step] for p in per]
            spans = [x["span"] for x in s]
            c = [x["comm"] for x in s]
            row = {"wall_ms": 1e3 * (max(e for _, e in spans) - min(b for b, _ in spans)),
                   **{k: [x[k] for x in s] for k in ("sync_ms", "counts_ms", "density_ms", "peers_ms", "owned",
                                                      "with_halos", "rho_gap")},
                   **{k: [x[k] for x in c] for k in c[0]}}
            m["steps"].append(row)
            what = f"{name}, " + ("cold step" if step == 0 else f"drift step {step}")
            print(f"{what}: {R}-rank sync wall {row['wall_ms']:.3f} ms; per rank sync ms {_fmt(row['sync_ms'])}, "
                  f"B1 call ms {_fmt(row['counts_ms'])}, B2 call ms {_fmt(row['density_ms'])}, find_peers_mac ms "
                  f"{_fmt(row['peers_ms'])}; owned {row['owned']}, with halos {row['with_halos']}", flush=True)
            print(f"{what}: per rank all_to_all rounds {row['all_to_all']}, bytes {row['all_to_all_bytes']}; "
                  f"ragged rounds {row['ragged']}, bytes {row['ragged_bytes']}; ppermute rounds {row['ppermute']}, "
                  f"bytes {row['ppermute_bytes']}; staged through host memory {row['staged_bytes']}; largest "
                  f"relative density gap to one rank {max(row['rho_gap']):.3e}", flush=True)
        print(f"{name}: every rank at every step equal to the one-rank run (global tree, B1 by id, B2 within "
              f"rtol 1e-5, halo ids, partition, overflow 0)" + ("" if name == cfg["modes"][0] else
                                                              f" and to {cfg['modes'][0]} slot for slot")
              + f"; the last step's B1/B2 launches equal plain, largest gaps {json.dumps(m['plain_err'])}; "
              f"launches per rank {json.dumps([x.get('stencil_counts', 0) for x in m['launches']])} B1, "
              f"{json.dumps([x.get('stencil_density', 0) for x in m['launches']])} B2; peak memory allocated per "
              f"rank {json.dumps(m['peak_bytes'])} bytes", flush=True)
        summary["modes"][name] = m
    summary["seconds"] = seconds
    return summary


def report_sim(sims: list) -> dict:
    """Print the simulation loop's line from every rank's sim_rank
    record; returns its summary."""
    sim, R = sims[0], len(sims)
    one, got = sim["one_rank"], [r["ranks"] for r in sims]
    walls = [1e3 * (max(g[i]["span"][1] for g in got) - min(g[i]["span"][0] for g in got)) for i in range(len(one))]
    out = {"one_rank_ms": [x["ms"] for x in one], "one_rank_nb_share": [x["nb_ms"] / x["ms"] for x in one],
           "wall_ms": walls, "rank_ms": [[g[i]["ms"] for g in got] for i in range(len(one))],
           "rank_nb_share": [[g[i]["nb_ms"] / g[i]["ms"] for g in got] for i in range(len(one))],
           "energy": [x["energy"] for x in one], "energy_gap": sim["energy_gap"],
           "momentum_gap": sim["momentum_gap"], "momentum_tolerance": sim["tolerance_momentum"], "caps": sim["caps"]}
    print(f"simulation loop, dt {SIM_DT}, ng_max {SIM_NG_MAX}, capacities {sim['caps']}, cold step and "
          f"{len(one) - 1} steps: one rank ms {_fmt(out['one_rank_ms'])}, share in find_neighbors "
          f"{json.dumps([round(x, 4) for x in out['one_rank_nb_share']])}; {R} ranks wall ms {_fmt(walls)}, share "
          f"in find_neighbors per rank {json.dumps(out['rank_nb_share'])}; largest gaps to one rank: energy "
          f"{sim['energy_gap']:.3e} of |E| (1e-4), momentum {sim['momentum_gap']:.4e} "
          f"({sim['tolerance_momentum']:.4g})", flush=True)
    return out


# ---------------------------------------------------------------------------
# the steps mode under gravity (--grav)
# ---------------------------------------------------------------------------


def grav_config(n: int, n_ranks: int, steps: int, modes) -> dict:
    """Everything the ranks of the grav steps mode share: the sizes of
    grav_ranks (its particles, h, theta, bucket), the cold step's first
    capacities (first_caps), the one-card run's tree capacity and the
    modes with pool first (the p2p modes are held to it)."""
    from . import grav_ranks as gr

    for m in modes:
        if m not in STEP_MODES:
            raise ValueError(f"unknown mode {m!r}; the modes are {sorted(STEP_MODES)}")
    return {"grav": True, "n": n, "ranks": n_ranks, "steps": steps,
            "modes": sorted(modes, key=lambda m: m != "pool"), "h": gr.H, "theta": gr.THETA,
            "bucket": gr.BUCKET, "caps": first_caps(n, n_ranks, gr.BUCKET), "tree": tree_capacity(n, gr.BUCKET)}


def grav_reference_steps(setup: dict, steps: int, tree_cap: int):
    """The one-card run of the same particles and steps (grav_steps with no
    comm: Domain(comm=None), sync_with_retry on the tree capacity) on
    setup's device, its centres held at every step to the float64 oracle
    (one_rank_checks). Returns (its steps, their step_sums, its numbers:
    sync and centres ms a step, capacities, largest gap to the oracle,
    seconds)."""
    from . import grav_ranks as gr

    t0 = time.perf_counter()
    ref, caps = gr.grav_steps(None, setup, {"tree": tree_cap}, None, steps)
    gap = max(gr.one_rank_checks(f"the one-card run, step {s}", r) for s, r in enumerate(ref))
    sums = [gr.step_sums(r) for r in ref]
    return ref, sums, {"sync_ms": [1e3 * (r["span"][1] - r["span"][0]) for r in ref],
                       "centers_ms": [r["centers_ms"] for r in ref], "caps": caps, "oracle_gap": gap,
                       "seconds": time.perf_counter() - t0}


def grav_rank_steps(comm, setup: dict, name: str, cfg: dict, ref: list, sums: list, pool: Optional[list] = None):
    """One rank's syncGrav steps in mode `name` of STEP_MODES, run by every
    rank: grav_steps from cfg's first capacities (a cold step under
    sync_with_retry, a window grown from 1 in window mode; then
    cfg["steps"] drift steps, each sync followed by
    update_expansion_centers), every step held by grav_ranks.rank_checks
    against the one-card run (`ref`, `sums`) and, with `pool` (the pool
    mode's slot records), against the pool mode. In window mode the cold
    tries must have grown the window to R - 1 from overflow_detail[6].
    Raises on a failure. Returns (the numbers, the slot records, the
    steps)."""
    from . import grav_ranks as gr

    mode, protocol, window = STEP_MODES[name]
    R = comm.n_ranks
    outs, caps = gr.grav_steps(comm, setup, cfg["caps"], mode, cfg["steps"], protocol=protocol, window=window)
    tries = outs[0]["tries"]
    if window:
        reported = [d[6] for _, d in tries]
        if tries[-1][0] != R - 1 or (window < R - 1 and max(reported) != R - 1):
            raise RuntimeError(f"{name}, rank {comm.rank}: the window grew {[w for w, _ in tries]} on "
                               f"overflow_detail[6] {reported}, not to R - 1 = {R - 1}")
    numbers = []
    for step, got in enumerate(outs):
        what = f"{name}, " + ("cold step" if step == 0 else f"drift step {step}")
        staged = got["stats"]["staged_bytes"] + got["c_stats"]["staged_bytes"]
        if getattr(comm, "backend", None) == "nccl" and staged:
            raise RuntimeError(f"{what}, rank {comm.rank}: {staged} bytes staged through host memory under nccl")
        cmp = gr.rank_checks(what, comm, got, ref[step], sums[step], None if pool is None else pool[step])
        res = got["res"]
        owned = int(res.end_index) - int(res.start_index)
        numbers.append({"span": got["span"], "sync_ms": 1e3 * (got["span"][1] - got["span"][0]),
                        "centers_ms": got["centers_ms"], "comm": got["stats"], "centers_comm": got["c_stats"],
                        "owned": owned, "halos": int(res.n_with_halos) - owned,
                        "overflow_detail": res.overflow_detail.tolist(), **cmp})
    return {"caps": caps, "window": tries[-1][0], "tries": tries, "steps": numbers}, \
        [gr.slot_record(o) for o in outs], outs


def grav_rank(comm, cfg: dict, device=None) -> dict:
    """One rank of the grav steps mode (every rank runs it; spawned rank
    processes import it from here): the one-card run on the rank's own
    device, so that no rank waits on another's, then every mode of cfg in
    turn (grav_rank_steps), the p2p modes held to pool. The device is
    `device`, else the comm's (a rank process's DistComm names one), else
    the card (resolve_device: a thread rank of run_ranks runs on the CPU
    only when the caller names it). Returns the rank's numbers and the
    kernel launches counted in the run (syncGrav calls none of the
    cell-list kernels; on a card its keys go through the key codec)."""
    from . import grav_ranks as gr
    from .utils.device import resolve_device

    dev = resolve_device(device if device is not None else getattr(comm, "device", None))
    cuda = dev.type == "cuda"
    before = _kernel_launches()
    setup = gr.grav_setup(cfg["n"], dev)
    ref, sums, ref_numbers = grav_reference_steps(setup, cfg["steps"], cfg["tree"])
    if comm.rank == 0:
        print(f"rank 0: the one-card run took {ref_numbers['seconds']:.3f} s", flush=True)
    out = {"rank": comm.rank, "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
           "reference": ref_numbers, "modes": {}}
    pool = None
    for name in cfg["modes"]:
        t0 = time.perf_counter()
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        numbers, records, outs = grav_rank_steps(comm, setup, name, cfg, ref, sums, pool)
        numbers["peak"] = torch.cuda.max_memory_allocated(dev) if cuda else None
        numbers["seconds"] = time.perf_counter() - t0
        out["modes"][name] = numbers
        if name == "pool":
            pool = records
        del outs
        if comm.rank == 0:
            print(f"rank 0: mode {name} held to the one-card run" + ("" if pool is None or name == "pool" else
                                                                     " and to pool")
                  + f" in {numbers['seconds']:.3f} s", flush=True)
    now = _kernel_launches()
    out["launches"] = {k: now[k] - before.get(k, 0) for k in now}
    return out


def report_grav(recs: list, cfg: dict, backend: str, seconds: float, tag: str = "") -> dict:
    """Print the grav steps mode's lines (each led by `tag`) from every
    rank's grav_rank record; returns the summary that the last line
    prints as JSON."""
    from . import grav_ranks as gr

    R = len(recs)
    summary = {"mode": "grav steps", "ranks": R, "backend": backend, "devices": [r["device"] for r in recs],
               **{k: cfg[k] for k in ("n", "steps", "h", "theta", "bucket", "caps", "tree")}, "modes": {}}
    ref = recs[0]["reference"]
    print(f"{tag}one-card syncGrav, {cfg['n']} particles on each rank's {recs[0]['device']}: sync ms (cold, then "
          f"drift) {_fmt(ref['sync_ms'])}, centres ms {_fmt(ref['centers_ms'])}, capacities {ref['caps']}, "
          f"centres {max(r['reference']['oracle_gap'] for r in recs):.3e} off the float64 oracle at most", flush=True)
    summary["reference"] = {"sync_ms": [r["reference"]["sync_ms"] for r in recs],
                            "centers_ms": [r["reference"]["centers_ms"] for r in recs], "caps": ref["caps"]}
    for name in cfg["modes"]:
        per = [r["modes"][name] for r in recs]
        m = {"window": per[0]["window"], "tries": per[0]["tries"], "caps": per[0]["caps"],
             "peak_bytes": [p["peak"] for p in per], "seconds": [p["seconds"] for p in per], "steps": []}
        print(f"{tag}{name}: cold tries (window, overflow_detail) {json.dumps(per[0]['tries'])}, capacities "
              f"{per[0]['caps']}", flush=True)
        for step in range(1 + cfg["steps"]):
            s = [p["steps"][step] for p in per]
            spans = [x["span"] for x in s]
            row = {"wall_ms": 1e3 * (max(e for _, e in spans) - min(b for b, _ in spans)),
                   **{k: [x[k] for x in s] for k in ("sync_ms", "centers_ms", "owned", "halos", "nodes", "held",
                                                      "gap", "pos", "mass", "sphere")},
                   **{k: [x["comm"][k] for x in s] for k in s[0]["comm"]},
                   "centers_comm": [x["centers_comm"] for x in s],
                   "one_card_sync_ms": [r["reference"]["sync_ms"][step] for r in recs]}
            m["steps"].append(row)
            what = f"{tag}{name}, " + ("cold step" if step == 0 else f"drift step {step}")
            print(f"{what}: {R}-rank sync wall {row['wall_ms']:.3f} ms; per rank sync ms {_fmt(row['sync_ms'])}, "
                  f"centres ms {_fmt(row['centers_ms'])}; the one-card run's sync ms "
                  f"{_fmt(row['one_card_sync_ms'])}; owned {row['owned']}, halo particles {row['halos']}", flush=True)
            print(f"{what}: per rank all_to_all rounds {row['all_to_all']}, bytes {row['all_to_all_bytes']}; "
                  f"ragged rounds {row['ragged']}, bytes {row['ragged_bytes']}; ppermute rounds {row['ppermute']}, "
                  f"bytes {row['ppermute_bytes']}; staged through host memory {row['staged_bytes']}; the centres' "
                  f"rounds (all_to_all, ragged, ppermute) "
                  f"{[(c['all_to_all'], c['ragged'], c['ppermute']) for c in row['centers_comm']]}", flush=True)
            print(f"{what}: focus nodes {row['nodes']}, held to rtol {gr.CENTER_RTOL} in the rank's own range "
                  f"{row['held']}, largest gap there {max(row['gap']):.3e}; outside, rounding units off the float64 "
                  f"oracle (limit {gr.OUTSIDE_UNITS}): positions {json.dumps([round(x, 4) for x in row['pos']])}, "
                  f"masses {json.dumps([round(x, 4) for x in row['mass']])}", flush=True)
        print(f"{tag}{name}: every rank at every step held to the one-card run (overflow 0, the owned ids a "
              f"partition, own nodes within rtol {gr.CENTER_RTOL}, others within {gr.OUTSIDE_UNITS} rounding units "
              f"of the float64 oracle)" + (" and to pool slot for slot" if name != "pool" and "pool" in cfg["modes"]
                                           else "")
              + f"; peak memory allocated per rank {json.dumps(m['peak_bytes'])} bytes", flush=True)
        summary["modes"][name] = m
    summary["launches"] = [r["launches"] for r in recs]
    summary["seconds"] = seconds
    return summary


@contextlib.contextmanager
def _leave_on_failure():
    """Around a torchrun rank's work: on an exception, print its traceback
    and end the process with exit code 1 at once. Its peers may be waiting
    in a collective for it; destroy_process_group, or NCCL's teardown at
    exit, would then wait for them until the collective's timeout, and the
    traceback would not show until then. torchrun stops the other ranks
    when one exits with an error."""
    try:
        yield
    except Exception:
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)


def _main_steps(args) -> int:
    """The steps mode of main (with --grav its syncGrav form): spawned
    ranks (--ranks) or torchrun's. Under torchrun rank 0 prints the modes'
    lines before the simulation loop starts, so that they survive a
    failure there."""
    from .parallel import dist as pdist

    t0 = time.perf_counter()
    modes = [m for m in args.modes.split(",") if m]
    if args.grav:
        def config(R):
            return grav_config(args.n_total, R, args.steps, modes)
        rank_fn, report = grav_rank, report_grav
    else:
        def config(R):
            return steps_config(args.n_total, R, args.steps, modes, args.sim_steps)
        rank_fn, report = steps_rank, report_steps
    if args.ranks is not None:
        from .utils.device import resolve_device

        dev = resolve_device(args.device) if args.backend == "gloo" else torch.device("cuda")
        cfg = config(args.ranks)
        if not args.grav and dev.type == "cuda" and torch.cuda.is_available():  # built once, before the ranks
            for lib in _libraries():
                lib.load()
        recs = pdist.spawn_ranks(args.ranks, grav_rank if args.grav else spawned_rank, [cfg] * args.ranks,
                                 backend=args.backend, device=dev, timeout=args.timeout)
        summary = report(recs, cfg, args.backend, time.perf_counter() - t0)
        if cfg.get("sim_steps"):
            summary["sim"] = report_sim([r["sim"] for r in recs])
    else:
        comm = pdist.comm_from_env(args.backend, args.device, timeout=args.timeout)
        cfg = config(comm.n_ranks)

        def gathered(rec):
            recs = [None] * comm.n_ranks
            torch.distributed.all_gather_object(recs, rec)
            return recs

        with _leave_on_failure():
            if comm.device.type == "cuda" and not args.grav:  # syncGrav runs none of these kernels
                load_kernels(comm, int(os.environ.get("LOCAL_RANK", comm.rank)) == 0)
            rec = rank_fn(comm, cfg)
            recs = gathered(rec)
            summary = report(recs, cfg, args.backend, time.perf_counter() - t0) if comm.rank == 0 else None
            if cfg.get("sim_steps"):
                sims = gathered(sim_rank(comm, cfg, sim_caps(rec)))
                if comm.rank == 0:
                    summary["sim"] = report_sim(sims)
        torch.distributed.destroy_process_group()
        if comm.rank != 0:
            return 0
        summary["seconds"] = time.perf_counter() - t0
    print(json.dumps(summary), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=None,
                    help="rank processes to spawn (omit under torchrun, which starts them)")
    ap.add_argument("--backend", choices=("gloo", "nccl"), required=True)
    ap.add_argument("--device", default=None, help="gloo only: cpu, or the card all ranks share (default)")
    ap.add_argument("--n-per-rank", type=int, default=N_PER, help="the dry run's particles a rank")
    ap.add_argument("--steps", type=int, default=None,
                    help="run the steps mode: a cold step and this many drift steps in each mode")
    # not "--n": torchrun's parser takes any prefix of its own options
    # (--nnodes, --nproc-per-node) for them, even after the module
    ap.add_argument("--n-total", type=int, default=4_000_000, help="the steps mode's particles over all ranks")
    ap.add_argument("--modes", default=",".join(STEP_MODES), help="the steps mode's modes, comma-separated")
    ap.add_argument("--sim-steps", type=int, default=2,
                    help="the steps mode's simulation steps after its cold step (0: no simulation loop)")
    ap.add_argument("--grav", action="store_true",
                    help="with --steps: syncGrav (sync(grav=True) + update_expansion_centers) in each mode, held to "
                         "a one-card run and the float64 centre of mass; no simulation loop")
    ap.add_argument("--timeout", type=float, default=1800.0, help="seconds a collective may wait")
    args = ap.parse_args(argv)
    if args.grav and args.steps is None:
        ap.error("--grav runs in the steps mode: give --steps")
    if args.ranks is None and "RANK" not in os.environ:
        raise ValueError("without --ranks this runs one rank of torchrun's, and RANK is not set: give --ranks, "
                         "or start it under torchrun")
    if args.steps is not None:
        return _main_steps(args)
    t0 = time.perf_counter()
    if args.ranks is not None:
        out = dryrun_multichip(args.ranks, args.device, args.backend, args.n_per_rank)
        rec, n_ranks = out[0], args.ranks
    else:
        from .parallel.dist import comm_from_env

        comm = comm_from_env(args.backend, args.device, timeout=args.timeout)
        with _leave_on_failure():
            rec, n_ranks = _both_protocols(comm, args.n_per_rank), comm.n_ranks
        torch.distributed.destroy_process_group()
        if comm.rank != 0:
            return 0
    expected = expected_sum(n_ranks, args.n_per_rank)
    if args.ranks is None:
        check_run(rec, n_ranks, args.n_per_rank, expected)
    print(json.dumps({"ranks": n_ranks, "backend": args.backend, "n_per_rank": args.n_per_rank,
                      "brute_force": expected, "seconds": time.perf_counter() - t0, "rank0": rec}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
