"""p2p-mode Domain of the PyTorch port with protocol="ragged" (the range
services and the halo exchange of parallel/ragged.py) on 8 ranks of
run_ranks threads against the JAX package's ragged mode inside shard_map
on the 8 virtual CPU devices, where JAX runs its emulation of
ragged_all_to_all: 8 ranks x 250 particles, buckets 16/8, tree capacity
1024, focus capacity 2048, local capacity 1000, open and periodic boxes, a
cold step and a warm step fed by compact_owned plus a drift (the inputs
and step functions of tests/test_torch_domain_pool.py), at the ragged
defaults of Domain._p2p_caps; the Domain's constructor checks.

Tolerance: every rank's SyncResult bit-equal slot for slot, the particle
exchange record, the ragged halo record (its gather and scatter streams
and the negotiated meta) and the 7-entry overflow_detail included;
exchange_halos and reapply_sync equal JAX's; the neighbour counts over the
owned slots sum to the brute-force total; every rank's assignment, focus
tree, halo flags, layout and buffer equal to the dense protocol's; and
totals below the need reported unclamped, the grown capacities giving
the same result."""

import numpy as np
import pytest
import torch

from cstone_tpu_torch.domain import CAP_NAMES, Domain
from cstone_tpu_torch.parallel.ragged import RaggedHaloRecord
from tests.test_domain import brute_force_total
from tests.test_torch_domain import _assert_same
from tests.test_torch_domain_p2p import EX_FIELDS, RESULT_FIELDS, owned_neighbor_count
from tests.test_torch_domain_pool import (CAP, N, N_PER, R, STATE_FIELDS, _get, drifted, initial, jax_pool_step,
                                          port_pool_step, rank_slice)

import torch_threads  # noqa: F401  (two intra-op threads per xdist worker)

HALO_FIELDS = ("gather_idx", "gather_valid", "scatter_idx", "scatter_valid", "overflow")
META_FIELDS = ("input_offsets", "send_sizes", "output_offsets", "recv_sizes", "recv_offsets",
               "ret_output_offsets", "overflow")


def assert_ragged_rank_same(jout, tout, r):
    """Rank r's ragged p2p results bit-equal to JAX's, records included."""
    js, jr = rank_slice(jout[0], r), rank_slice(jout[1], r)
    ts, tr = tout[0], tout[1]
    for f in RESULT_FIELDS:
        _assert_same(getattr(jr, f), getattr(tr, f), f"rank {r}: {f}")
    _assert_same(jr.properties[0], tr.properties[0], f"rank {r}: m")
    _assert_same(jr.tree.leaves, tr.tree.leaves, f"rank {r}: tree.leaves")
    _assert_same(jr.tree.n_leaf, tr.tree.n_leaf, f"rank {r}: tree.n_leaf")
    for f in EX_FIELDS:
        _assert_same(getattr(jr.ex_record, f), getattr(tr.ex_record, f), f"rank {r}: ex_record.{f}")
    assert isinstance(tr.halo_record, RaggedHaloRecord)
    assert tr.halo_record.halo_total_cap == jr.halo_record.halo_total_cap
    for f in HALO_FIELDS:
        _assert_same(getattr(jr.halo_record, f), getattr(tr.halo_record, f), f"rank {r}: halo_record.{f}")
    for f in META_FIELDS:
        _assert_same(getattr(jr.halo_record.meta, f), getattr(tr.halo_record.meta, f),
                     f"rank {r}: halo_record.meta.{f}")
    for f in STATE_FIELDS:
        _assert_same(_get(js, f), _get(ts, f), f"rank {r}: state.{f}")
    assert bool(js.focus_converged) == ts.focus_converged
    _assert_same(jout[4][r], tout[4], f"rank {r}: reapply_sync")
    _assert_same(jout[5][r], tout[5], f"rank {r}: exchange_halos")


def run_steps(periodic, n_steps=2, seed=17):
    """Per step (cols, n_local, JAX outputs, port outputs per rank), both
    sides fed the port's compact-owned particles plus one drift."""
    jrun = jax_pool_step(periodic, mode="p2p", protocol="ragged")
    trun = port_pool_step(periodic, mode="p2p", protocol="ragged")
    cols, ids, _, _ = initial(seed=seed)
    n_local = [N_PER] * R
    steps, jstate, tstates = [], None, None
    for s in range(n_steps):
        jout = jrun(jstate, cols, n_local, ids)
        touts = trun(tstates, cols, n_local, ids)
        steps.append((cols, n_local, jout, touts, ids))
        jstate, tstates = jout[0], [t[0] for t in touts]
        n_local = [int(t[3]) for t in touts]
        ids = np.stack([Domain.compact_owned(t[1], t[4]).numpy() for t in touts])
        ids = np.where(np.arange(CAP)[None] < np.asarray(n_local)[:, None], ids, -1)
        cols = drifted([t[2] for t in touts], n_local, periodic, seed=100 + s)
    return steps


@pytest.fixture(scope="module", params=[False, True], ids=["open", "periodic"])
def runs(request):
    return request.param, run_steps(request.param)


@pytest.mark.parametrize("step", [0, 1], ids=["cold", "warm"])
def test_ragged_sync_matches_jax_per_rank(runs, step):
    _, steps = runs
    _, _, jout, touts, _ = steps[step]
    for r in range(R):
        assert_ragged_rank_same(jout, touts[r], r)
        assert int(touts[r][1].overflow) == 0
        assert touts[r][-1].protocol == "ragged"
    assert sum(int(t[3]) for t in touts) == N
    # one flat stream a rank, sized by the ragged default halo total
    assert all(t[1].halo_record.gather_idx.shape == (2 * CAP,) for t in touts)
    assert all(int(t[1].n_with_halos) > int(t[3]) for t in touts)
    if step == 1:
        assert all(t[0].focus_converged for t in touts)


def test_ragged_neighbor_sum_matches_brute_force(runs):
    periodic, steps = runs
    cols, n_local, _, touts, _ = steps[1]
    pos = np.concatenate([cols[:3, r, :n].T for r, n in enumerate(n_local)])
    h = np.concatenate([cols[3, r, :n] for r, n in enumerate(n_local)])
    total = sum(owned_neighbor_count(t[-1], t[0], t[1]) for t in touts)
    limits = touts[0][0].box.limits.numpy()
    assert total == brute_force_total(pos, h, limits, periodic)


def test_ragged_equals_dense_on_the_same_particles(runs):
    # both protocols count the same cells and move the same halo particles:
    # the same assignment, focus tree, halos, layout and buffers
    periodic, steps = runs
    drun = port_pool_step(periodic, mode="p2p", protocol="dense")
    states = None
    for s, (cols, n_local, _, touts, ids) in enumerate(steps):
        douts = drun(states, cols, n_local, ids)
        states = [d[0] for d in douts]
        for r, (d, t) in enumerate(zip(douts, touts)):
            _assert_same(d[0].assignment.boundaries.numpy(), t[0].assignment.boundaries, f"rank {r}: boundaries")
            _assert_same(d[1].tree.leaves.numpy(), t[1].tree.leaves, f"rank {r}: leaves")
            for f in ("halo_flags", "layout", "n_with_halos", "start_index", "end_index", "keys", "x", "h",
                      "leaf_counts"):
                _assert_same(getattr(d[1], f).numpy(), getattr(t[1], f), f"rank {r}, step {s}: {f}")
            _assert_same(d[5].numpy(), t[5], f"rank {r}, step {s}: halo ids")
            _assert_same(d[4].numpy(), t[4], f"rank {r}, step {s}: reapply_sync")


def test_ragged_overflow_reports_totals_and_the_retry_fits(runs):
    # halo totals below the need clamp the request and particle rounds
    # consistently and report the unclamped total; sync_with_retry's
    # growth gives the default run's result. (A clamped count service
    # leaves the focus tree unconverged for many iterations, slow here;
    # tests/test_torch_ragged.py clamps the services.)
    periodic, steps = runs
    cols, n_local, _, touts, ids = steps[0]
    caps = {"halo": 256}
    for attempt in range(5):
        outs = port_pool_step(periodic, mode="p2p", protocol="ragged", halo_req_cap=caps["halo"],
                              halo_cap=caps["halo"])(None, cols, n_local, ids)
        detail = outs[0][1].overflow_detail
        assert all(torch.equal(o[1].overflow_detail, detail) for o in outs)
        if attempt == 0:
            assert int(detail[5]) > 256 and int(detail.sum()) == int(detail[5]), detail
        if int(outs[0][1].overflow) == 0:
            break
        for i, nm in enumerate(CAP_NAMES):
            if detail[i] > 0:  # sync_with_retry's growth rule
                caps[nm] = max(int(caps.get(nm, 0) * 1.6) + 8, int(detail[i]) + 8)
    assert attempt > 0 and caps["halo"] > 256
    for r, (g, t) in enumerate(zip(outs, touts)):
        assert int(g[1].overflow) == 0
        nl = int(t[1].tree.n_leaf)  # a grown focus capacity pads the leaf arrays further
        _assert_same(t[1].tree.leaves.numpy(), g[1].tree.leaves, f"rank {r}: leaves", nl + 1)
        for f, n in (("layout", nl + 1), ("halo_flags", nl), ("keys", None), ("x", None), ("h", None),
                     ("n_with_halos", None), ("start_index", None), ("end_index", None)):
            _assert_same(getattr(t[1], f).numpy(), getattr(g[1], f), f"rank {r}: {f}", n)
        _assert_same(t[5].numpy(), g[5], f"rank {r}: halo ids")


def test_ragged_constructor_checks():
    # the ragged protocols have no rank window (JAX's ValueError), and at
    # one rank the window is 0; the dense window is taken, clipped to 0 at
    # one rank
    with pytest.raises(ValueError, match="peer_window applies to protocol='dense' only"):
        Domain(rank=0, n_ranks=2, protocol="ragged", peer_window=1, bucket_size=16, tree_capacity=256,
               device="cpu")
    assert Domain(protocol="dense", peer_window=1, bucket_size=16, tree_capacity=256, device="cpu").peer_window == 0
    with pytest.raises(ValueError, match="unknown protocol"):
        Domain(protocol="sparse", bucket_size=16, tree_capacity=256, device="cpu")
    assert Domain(protocol="ragged", peer_window=1, bucket_size=16, tree_capacity=256, device="cpu").protocol == "ragged"
    assert Domain(bucket_size=16, tree_capacity=256, device="cpu").protocol == "dense"
