"""The multi-rank dry run: one Domain.sync per rank, each rank its own
process, then a neighbour count over every rank's buffer, held to the
O(n^2) count of the same particles (counterpart of the JAX package's
`__graft_entry__.dryrun_multichip`; reference: the flagship invariant of
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
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import numpy as np
import torch

__all__ = ["dryrun_multichip", "rank_step", "particles", "brute_force_pairs", "PROTOCOLS"]

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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=None,
                    help="rank processes to spawn (omit under torchrun, which starts them)")
    ap.add_argument("--backend", choices=("gloo", "nccl"), required=True)
    ap.add_argument("--device", default=None, help="gloo only: cpu, or the card all ranks share (default)")
    ap.add_argument("--n-per-rank", type=int, default=N_PER)
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    if args.ranks is not None:
        out = dryrun_multichip(args.ranks, args.device, args.backend, args.n_per_rank)
        rec, n_ranks = out[0], args.ranks
    else:
        from .parallel.dist import comm_from_env

        comm = comm_from_env(args.backend, args.device)
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
