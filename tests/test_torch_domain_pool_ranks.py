"""The rank-level contract of the PyTorch port's pool-mode Domain, on 8
ranks of run_ranks threads (port only; the JAX parity of the same sync
is tests/test_torch_domain_pool.py): a Domain takes its rank from its
comm and lives across run_ranks calls, the overflow is the largest of all
ranks, and sync_with_retry runs inside run_ranks with every rank taking
the same decisions. 8 ranks x 250 particles, open box, the inputs of
test_torch_domain_pool. Exact comparisons throughout."""

import numpy as np
import pytest
import torch

from cstone_tpu_torch.domain import Domain, sync_with_retry
from cstone_tpu_torch.parallel import run_ranks
from tests.test_torch_domain import _assert_same
from tests.test_torch_domain_pool import CAP, KW, N_PER, R, initial, port_pool_step

import torch_threads  # noqa: F401  (two intra-op threads per xdist worker)

FIELDS = ("keys", "x", "h", "start_index", "end_index", "n_with_halos", "layout", "halo_flags",
          "global_ids", "pool_perm", "overflow")


def _sync(d, cols, cap):
    """Rank d.rank's cold sync of its slice of `cols`, padded to cap."""
    x, y, z, h, m = (torch.from_numpy(np.ascontiguousarray(c)) for c in cols[:, d.rank, :cap])
    return d.sync(d.init_state(), x, y, z, h, properties=(m,), n_local=N_PER)


@pytest.fixture(scope="module")
def ranks():
    """(cols, the 8 Domains built in a run_ranks call of their own, each
    rank's (state, result) at local capacity CAP from a later call, and
    port_pool_step's results on the same inputs)."""
    cols, ids, _, _ = initial()
    domains = run_ranks(R, lambda comm: Domain(exchange_mode="pool", comm=comm, device="cpu", **KW))
    out = run_ranks(R, lambda comm, d: _sync(d, cols, CAP), domains)
    ref = port_pool_step(False)(None, cols, [N_PER] * R, ids)
    return cols, domains, out, ref


def test_domain_takes_its_rank_from_comm_and_lives_across_calls(ranks):
    _, domains, out, ref = ranks
    assert [(d.rank, d.n_ranks) for d in domains] == [(r, R) for r in range(R)]
    for r, (_, res) in enumerate(out):
        for f in FIELDS:
            _assert_same(getattr(ref[r][1], f), getattr(res, f), f"rank {r}: {f}")
    with pytest.raises(ValueError, match="comm"):
        run_ranks(2, lambda comm: Domain(rank=comm.rank, exchange_mode="pool", comm=comm, device="cpu"))


def test_pool_overflow_is_the_largest_of_all_ranks(ranks):
    # a local capacity that about half the ranks outgrow: every rank
    # reports the largest need of any rank, so all take the same retry
    cols, domains, out, _ = ranks
    need = sorted(int(res.n_with_halos) for _, res in out)
    cap = need[R // 2]
    assert need[0] <= cap < need[-1]
    for r, (_, res) in enumerate(run_ranks(R, lambda comm, d: _sync(d, cols, cap), domains)):
        assert int(res.n_with_halos) == int(out[r][1].n_with_halos)
        assert res.overflow_detail.tolist() == [need[-1]] + [0] * 6
        assert int(res.overflow) == need[-1]


def test_sync_with_retry_inside_run_ranks(ranks):
    # each rank runs the retry loop itself, from a capacity that some
    # ranks outgrow: all grow the same capacities and end with the layout
    # of the sync at CAP
    cols, domains, out, _ = ranks
    cap0 = sorted(int(res.n_with_halos) for _, res in out)[R // 2]

    def rank_fn(comm, d):
        return sync_with_retry(lambda caps: _sync(d, cols, caps["local"]), {"local": cap0})

    got = run_ranks(R, rank_fn, domains)
    assert len({caps["local"] for _, caps in got}) == 1 and got[0][1]["local"] > cap0
    for r, ((_, res), _) in enumerate(got):
        assert int(res.overflow) == 0
        want = out[r][1]
        for f in ("start_index", "end_index", "n_with_halos"):
            assert int(getattr(res, f)) == int(getattr(want, f)), f
        # the valid particles lead the sorted pool whatever the capacity
        nwh = int(res.n_with_halos)
        for f in ("global_ids", "x", "h"):
            np.testing.assert_array_equal(getattr(res, f)[:nwh].numpy(), getattr(want, f)[:nwh].numpy())
