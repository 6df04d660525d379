"""parallel/dist.py: the torch.distributed backend of the rank's comm, each
rank a process spawned by spawn_ranks under gloo on the CPU, against the
in-process backend (run_ranks threads) on the same inputs: every
collective, ragged_all_to_all with gaps, clamps and empty chunks
included; a failing rank, a rank that stops calling collectives, a rank
that dies and a run past its deadline all surface within their time
limits; nccl with fewer cards than ranks raises; the Domain in pool,
dense p2p and ragged p2p mode at 4 processes, a cold and a warm step,
open box; and multichip.dryrun_multichip(8, device="cpu") in
both protocols against brute force.

Tolerance: every tensor bit-equal to run_ranks' (the state, the
SyncResult with its records, reapply_sync and exchange_halos); the dry
run's neighbour sums equal to the O(n^2) count."""

import time

import numpy as np
import pytest
import torch

from cstone_tpu_torch import multichip
from cstone_tpu_torch.parallel import run_ranks
from cstone_tpu_torch.parallel.dist import DistComm, RankFailed, spawn_ranks

import torch_dist_ranks as ranks
import torch_threads  # noqa: F401  (two intra-op threads per xdist worker)

R = 4
GLOO = dict(backend="gloo", device="cpu", timeout=30.0, deadline=240.0)


def _same(a, b, what):
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b), what
    else:
        assert a == b, what


def test_collectives_equal_run_ranks():
    want = run_ranks(R, ranks.collectives, [7] * R)
    got = spawn_ranks(R, ranks.collectives, [7] * R, **GLOO)
    for r in range(R):
        assert want[r].keys() == got[r].keys()
        for k in want[r]:
            _same(want[r][k], got[r][k], f"rank {r}: {k}")
    # the ragged chunks landed where their senders declared
    operand, in_off, s, out_off, _ = ranks.ragged_case(R)
    for j in range(R):
        expect = np.full(24, -1.0, np.float32)
        for r in range(R):
            for t in range(s[r, j]):
                if out_off[r, j] + t < 24:
                    expect[out_off[r, j] + t] = operand[r, min(in_off[r, j] + t, operand.shape[1] - 1)]
        np.testing.assert_array_equal(got[j]["ragged"].numpy(), expect)
        assert (got[j]["ragged_empty"] == -1.0).all()


def test_failures_surface_within_their_limits():
    t0 = time.monotonic()
    with pytest.raises(KeyError, match="rank 2 failed") as info:
        spawn_ranks(R, ranks.fail_at, [2] * R, **GLOO)
    assert "rank 2 of 4, in its process" in str(info.value.__cause__)
    # the quiet rank's peers wait out the process group's timeout, then fail
    with pytest.raises(RuntimeError):
        spawn_ranks(R, ranks.stop_calling, [1] * R, backend="gloo", device="cpu", timeout=5.0, deadline=60.0)
    with pytest.raises(RankFailed, match="rank 3 of 4 died"):
        spawn_ranks(R, ranks.die, [3] * R, **GLOO)
    with pytest.raises(RankFailed, match="deadline"):
        spawn_ranks(2, ranks.sleep, [600] * 2, backend="gloo", device="cpu", timeout=30.0, deadline=3.0)
    assert time.monotonic() - t0 < 90


def test_backend_and_device_are_explicit():
    with pytest.raises(ValueError, match="one card a rank"):
        spawn_ranks(2, ranks.sleep, [0, 0], backend="nccl", device="cuda")
    with pytest.raises(ValueError, match="not a CUDA device"):
        spawn_ranks(2, ranks.sleep, [0, 0], backend="nccl", device="cpu")
    with pytest.raises(ValueError, match="backend"):
        spawn_ranks(2, ranks.sleep, [0, 0], backend="mpi", device="cpu")
    with pytest.raises(ValueError, match="not a CUDA device"):
        DistComm(0, 2, "nccl", "cpu")


def test_domain_modes_equal_run_ranks():
    # the open box; both boxes run in-process in test_torch_domain_ragged.py
    # and the p2p and pool tests
    cols, ids = ranks.initial(R)
    args = ([cols[:, r] for r in range(R)], list(ids), [False] * R)
    want = run_ranks(R, ranks.domain_steps, *args)
    got = spawn_ranks(R, ranks.domain_steps, *args, **GLOO)
    for r in range(R):
        assert want[r].keys() == got[r].keys()
        for step, fields in want[r].items():
            assert fields.keys() == got[r][step].keys()
            for k, v in fields.items():
                _same(v, got[r][step][k], f"rank {r}, {step}: {k}")
            assert int(fields["result.overflow"]) == 0
    assert "result.halo_record.meta.send_sizes" in want[0]["p2p-ragged-1"]


def test_dryrun_multichip_both_protocols():
    out = multichip.dryrun_multichip(8, device="cpu", timeout=60.0, deadline=240.0)
    pos, h = multichip.particles(8 * multichip.N_PER)
    expect = multichip.brute_force_pairs(pos, h)
    for p in multichip.PROTOCOLS:
        assert out[0][p]["total"] == expect and out[0][p]["overflow"] == 0
        assert sum(o[p]["owned"] for o in out) == 8 * multichip.N_PER
    # the cell-bounded brute force is the O(n^2) count
    X = pos.astype(np.float64)
    d2 = ((X[:, None] - X[None]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    assert expect == int((d2 < ((2.0 * h.astype(np.float64)) ** 2)[:, None]).sum())
    lo, mid, hi = multichip.brute_force_pairs(pos, h, multichip.F32_BAND)  # the band of a scaled run
    assert lo <= mid == expect <= hi
