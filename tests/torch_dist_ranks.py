"""Per-rank functions of tests/test_torch_dist.py, run both by run_ranks
threads and by spawn_ranks processes. Spawned processes import this
module by name, so it imports torch, numpy and the port only (no jax, no
conftest)."""

import dataclasses
import os
import time

import numpy as np
import torch

from cstone_tpu_torch.domain import Domain
from cstone_tpu_torch.sfc import PERIODIC, make_box

KW = dict(bucket_size=16, bucket_size_focus=8, tree_capacity=1024, focus_capacity=2048)
N_PER, CAP = 250, 1000


def ragged_case(n_ranks, seed=5, out_cap=24, op_len=20):
    """Per-rank operand, input offsets, send sizes, output offsets and
    receive sizes, (n_ranks, ...) each: chunks laid out at every receiver
    in rank order with gaps, the last rank's running past the output's
    end, zero sizes, and one rank's chunks starting at its operand's last
    row."""
    rng = np.random.RandomState(seed)
    s = rng.randint(0, 4, size=(n_ranks, n_ranks)).astype(np.int64)
    s[rng.uniform(size=s.shape) < 0.3] = 0
    in_off = np.concatenate([np.zeros((n_ranks, 1), np.int64), np.cumsum(s, 1)[:, :-1]], 1)
    gap = rng.randint(0, 3, size=s.shape)
    out_off = np.cumsum(np.vstack([np.zeros((1, n_ranks), np.int64), (s + gap)[:-1]]), 0) + gap
    out_off[-1] = out_cap - 1
    in_off[1, 2:] = op_len - 1
    operand = (np.arange(n_ranks)[:, None] * 1000 + np.arange(op_len)[None, :]).astype(np.float32)
    return operand, in_off, s, out_off, s.T.copy()


def collectives(comm, seed):
    """Every collective of a comm on per-rank inputs that differ by rank."""
    R, r = comm.n_ranks, comm.rank
    g = torch.Generator().manual_seed(seed + r)
    t = torch.randn(3, 2, generator=g)
    i64 = torch.randint(-5, 5, (4,), generator=g)
    out = {"all_gather": comm.all_gather(t), "all_gather_0d": comm.all_gather(torch.tensor(r)),
           "all_gather_bool": comm.all_gather(t > 0)}
    for op in ("sum", "max", "min"):
        out["all_reduce_" + op] = comm.all_reduce(i64, op)
    out["all_reduce_max_f"] = comm.all_reduce(t, "max")
    out["flags"] = [comm.all_reduce_flag(r % 2 == 1, "all"), comm.all_reduce_flag(r % 2 == 1, "any"),
                    comm.all_reduce_flag(True, "all"), comm.all_reduce_flag(False, "any")]
    out["all_to_all"] = comm.all_to_all(torch.randn(R, 2, generator=g))
    out["all_to_all_1d"] = comm.all_to_all(torch.arange(R) + 10 * r)
    operand, in_off, s, out_off, recv = (torch.from_numpy(np.ascontiguousarray(a[r])) for a in ragged_case(R))
    output = torch.full((24,), -1.0)
    out["ragged"] = comm.ragged_all_to_all(operand, output, in_off, s, out_off, recv)
    out["ragged_rows"] = comm.ragged_all_to_all(torch.stack([operand, -operand], -1),
                                                torch.full((24, 2), -1.0), in_off, s, out_off, recv)
    none = torch.zeros(R, dtype=torch.int64)  # every chunk empty: the rank still takes part
    out["ragged_empty"] = comm.ragged_all_to_all(operand, output, none, none, none, none)
    return out


def ppermutes(comm, seed):
    """ppermute on a ring, a one-way shift, pairs that leave ranks out,
    an empty pair list, and windowed_exchange at every window."""
    from cstone_tpu_torch.parallel.exchange import windowed_exchange

    R, r = comm.n_ranks, comm.rank
    g = torch.Generator().manual_seed(seed + r)
    t = torch.randn(3, 2, generator=g)
    out = {"ring": comm.ppermute(t, [(q, (q + 1) % R) for q in range(R)]),
           "shift": comm.ppermute(t, [(q, q + 1) for q in range(R - 1)]),
           "ends": comm.ppermute(t.to(torch.int64), [(0, R - 1), (R - 1, 0)]),
           "none": comm.ppermute(t, [])}
    for w in range(1, R):
        out[f"window{w}"] = windowed_exchange(torch.randint(-9, 9, (2 * w + 1, 4), generator=g), comm, w, R)
    return out


def fail_at(comm, bad_rank):
    """Rank bad_rank raises after one collective; the others go on to
    another, which it never joins."""
    comm.all_gather(torch.zeros(1))
    if comm.rank == bad_rank:
        raise KeyError(f"rank {bad_rank} failed")
    comm.all_gather(torch.zeros(1))
    return comm.rank


def stop_calling(comm, quiet_rank):
    """Rank quiet_rank leaves without joining the second collective."""
    comm.all_gather(torch.zeros(1))
    if comm.rank != quiet_rank:
        comm.all_gather(torch.zeros(1))
    return comm.rank


def die(comm, bad_rank):
    """Rank bad_rank ends its process without reporting."""
    if comm.rank == bad_rank:
        os._exit(3)
    time.sleep(60)


def sleep(comm, seconds):
    time.sleep(seconds)


def initial(n_ranks, seed=17):
    """(5, R, CAP) x, y, z, h, m: uniform positions in [-1, 1)^3, each
    rank starting from a contiguous slice of N_PER particles."""
    n = n_ranks * N_PER
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    h = rng.uniform(0.03, 0.06, size=n).astype(np.float32)
    m = rng.uniform(0.5, 1.5, size=n).astype(np.float32)
    cols = np.zeros((5, n_ranks, CAP), np.float32)
    for c, a in enumerate((pos[:, 0], pos[:, 1], pos[:, 2], h, m)):
        cols[c, :, :N_PER] = a.reshape(n_ranks, N_PER)
    ids = np.full((n_ranks, CAP), -1, np.int64)
    ids[:, :N_PER] = np.arange(n).reshape(n_ranks, N_PER)
    return cols, ids


def tensors_of(obj, prefix=""):
    """{path: tensor} of every tensor in a nest of dataclasses, tuples and
    lists."""
    if isinstance(obj, torch.Tensor):
        return {prefix: obj}
    if dataclasses.is_dataclass(obj):
        obj = {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}
    if isinstance(obj, (tuple, list)):
        obj = dict(enumerate(obj))
    out = {}
    if isinstance(obj, dict):
        for k, v in obj.items():
            out.update(tensors_of(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


MODES = (("pool", "dense", 0), ("p2p", "dense", 0), ("p2p", "ragged", 0))


def domain_steps(comm, cols, ids, periodic, modes=MODES):
    """A cold and a warm sync (compact_owned plus a fixed drift) in each of
    `modes`, (exchange mode, protocol, peer window) triples, by default
    pool, dense p2p and ragged p2p: per mode and step, every tensor of the
    state and SyncResult, reapply_sync and exchange_halos of the ids. The
    keys are "<mode>-<protocol>-<step>", with "-w<window>" before the
    step where the window is not 0."""
    box = make_box(-1.0, 1.0, boundaries=PERIODIC if periodic else 0, device="cpu")
    drift = torch.from_numpy(np.random.RandomState(100).uniform(-0.02, 0.02, size=(3, CAP)).astype(np.float32))
    out = {}
    for mode, protocol, window in modes:
        name = f"{mode}-{protocol}" + (f"-w{window}" if window else "")
        d = Domain(exchange_mode=mode, protocol=protocol, comm=comm, device="cpu", peer_window=window, **KW)
        state = d.init_state(box=box if periodic else None, boundaries=box.boundaries)
        x, y, z, h, m = (torch.from_numpy(np.ascontiguousarray(c)) for c in cols)
        pid, n_local = torch.from_numpy(ids), N_PER
        for step in range(2):
            state, res = d.sync(state, x, y, z, h, properties=(m,), n_local=n_local)
            rids = d.reapply_sync(res, pid)
            j = torch.arange(CAP)
            hids = d.exchange_halos(res, torch.where((j >= res.start_index) & (j < res.end_index), rids, -1))
            out[f"{name}-{step}"] = tensors_of({"state": state, "result": res, "rids": rids,
                                                          "hids": hids})
            co = d.compact_owned
            n_local = res.end_index - res.start_index
            live = j < n_local
            x, y, z = (torch.where(live, co(res, c) + drift[i], 0.0) for i, c in enumerate((res.x, res.y, res.z)))
            if periodic:
                x, y, z = (torch.where(live, (c + 1.0) % 2.0 - 1.0, 0.0) for c in (x, y, z))
            h, m = co(res, res.h), co(res, res.properties[0])
            pid = torch.where(live, co(res, rids), -1)
    return out
