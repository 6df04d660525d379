"""p2p-mode Domain of the PyTorch port (the default exchange mode) on 8
ranks of run_ranks threads against the JAX package's p2p mode (dense
protocol) inside shard_map on the 8 virtual CPU devices: 8 ranks x 250
particles, buckets 16/8, tree capacity 1024, focus capacity 2048, local
capacity 1000, open and periodic boxes, a cold step and a warm step fed
by compact_owned plus a drift (the inputs and step functions of
tests/test_torch_domain_pool.py).

Tolerance: every rank's SyncResult bit-equal slot for slot, the particle
and halo exchange records and the 7-entry overflow_detail included;
exchange_halos and reapply_sync equal JAX's; the neighbour counts over the
owned slots sum to the brute-force total."""

import numpy as np
import pytest

from cstone_tpu_torch.domain import Domain
from cstone_tpu_torch.traversal.neighbors import _find_neighbors_impl
from tests.test_domain import brute_force_total
from tests.test_torch_domain import _assert_same
from tests.test_torch_domain_pool import (CAP, N, N_PER, R, STATE_FIELDS, _get, drifted, initial, jax_pool_step,
                                          port_pool_step, rank_slice)

import torch_threads  # noqa: F401  (two intra-op threads per xdist worker)

RESULT_FIELDS = ("keys", "x", "y", "z", "h", "start_index", "end_index", "n_with_halos", "layout",
                 "halo_flags", "leaf_counts", "sort_order", "overflow", "overflow_detail")
EX_FIELDS = ("send_idx", "send_valid", "merge_perm", "n_owned", "overflow")
HALO_FIELDS = ("send_idx", "send_valid", "recv_idx", "recv_valid", "overflow")


def assert_p2p_rank_same(jout, tout, r, leaves_only=()):
    """Rank r's p2p results bit-equal, records included; the fields in
    `leaves_only` over the tree's n_leaf leaves."""
    js, jr = rank_slice(jout[0], r), rank_slice(jout[1], r)
    ts, tr = tout[0], tout[1]
    for f in RESULT_FIELDS:
        n = int(tr.tree.n_leaf) if f in leaves_only else None
        _assert_same(getattr(jr, f), getattr(tr, f), f"rank {r}: {f}", n)
    _assert_same(jr.properties[0], tr.properties[0], f"rank {r}: m")
    _assert_same(jr.tree.leaves, tr.tree.leaves, f"rank {r}: tree.leaves")
    _assert_same(jr.tree.n_leaf, tr.tree.n_leaf, f"rank {r}: tree.n_leaf")
    assert jr.global_ids is None and tr.global_ids is None
    for f in EX_FIELDS:
        _assert_same(getattr(jr.ex_record, f), getattr(tr.ex_record, f), f"rank {r}: ex_record.{f}")
    for f in HALO_FIELDS:
        _assert_same(getattr(jr.halo_record, f), getattr(tr.halo_record, f), f"rank {r}: halo_record.{f}")
    for f in STATE_FIELDS:
        _assert_same(_get(js, f), _get(ts, f), f"rank {r}: state.{f}")
    assert bool(js.focus_converged) == ts.focus_converged
    _assert_same(jout[4][r], tout[4], f"rank {r}: reapply_sync")
    _assert_same(jout[5][r], tout[5], f"rank {r}: exchange_halos")


def run_steps(periodic, n_steps=2, seed=17, **caps):
    """(steps, each (cols, n_local, JAX outputs, port outputs per rank,
    ids)), both sides fed the port's compact-owned particles plus one
    drift."""
    jrun, trun = jax_pool_step(periodic, mode="p2p", **caps), port_pool_step(periodic, mode="p2p", **caps)
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
def test_p2p_sync_matches_jax_per_rank(runs, step):
    _, steps = runs
    _, _, jout, touts, _ = steps[step]
    for r in range(R):
        assert_p2p_rank_same(jout, touts[r], r)
        assert int(touts[r][1].overflow) == 0
        assert touts[r][-1].exchange_mode == "p2p"
    assert sum(int(t[3]) for t in touts) == N
    # the ranks have halos, and the warm step reuses the carried trees
    assert all(int(t[1].n_with_halos) > int(t[3]) for t in touts)
    if step == 1:
        assert all(t[0].focus_converged for t in touts)


def test_p2p_halo_slots_carry_owner_ids(runs):
    # reapply_sync routes the ids to the owned slots only (halo slots 0);
    # exchange_halos fills every halo slot with its owner's id, which
    # names the particle whose x the slot holds
    _, steps = runs
    cols, _, _, touts, _ = steps[0]
    x_of_id = np.concatenate([cols[0, r, :N_PER] for r in range(R)])
    for out in touts:
        res, rids, hids = out[1], out[4].numpy(), out[5].numpy()
        s, e, nwh = int(res.start_index), int(res.end_index), int(res.n_with_halos)
        j = np.arange(rids.shape[0])
        halo = (j < nwh) & ((j < s) | (j >= e))
        assert (rids[halo] == 0).all()
        np.testing.assert_array_equal(hids[s:e], rids[s:e])
        assert (hids[:nwh] >= 0).all() and (hids[nwh:] == -1).all()
        np.testing.assert_array_equal(res.x[:nwh].numpy(), x_of_id[hids[:nwh]])


def owned_neighbor_count(domain, state, res):
    """The neighbour counts of a rank's owned slots, summed (octree
    find_neighbors over the rank's buffer, halos included)."""
    view = domain.ns_view(res, state.box)
    counts, _, stats = _find_neighbors_impl(
        res.x, res.y, res.z, res.h, view, state.box, ng_max=1, group_size=16, cand_leaf_cap=512,
        cand_cap=8192, chunk=8, with_indices=False, n_targets=res.x.shape[0], frontier_cap=64)
    assert int(stats.cand_max) <= 8192 and int(stats.leaf_max) <= 512 and int(stats.frontier_max) <= 64
    return int(counts[int(res.start_index):int(res.end_index)].sum())


def test_p2p_neighbor_sum_matches_brute_force(runs):
    periodic, steps = runs
    cols, n_local, _, touts, _ = steps[1]
    pos = np.concatenate([cols[:3, r, :n].T for r, n in enumerate(n_local)])
    h = np.concatenate([cols[3, r, :n] for r, n in enumerate(n_local)])
    total = sum(owned_neighbor_count(t[-1], t[0], t[1]) for t in touts)
    limits = touts[0][0].box.limits.numpy()
    assert total == brute_force_total(pos, h, limits, periodic)


def test_p2p_equals_pool_on_the_same_particles(runs):
    # both modes build each rank's tree from exact counts of the same
    # particles: the same assignment, focus tree, halos and layout, and the
    # same particle in every buffer slot (chip_smoke path F against path E)
    periodic, steps = runs
    prun = port_pool_step(periodic, mode="pool")
    states = None
    for s, (cols, n_local, _, touts, ids) in enumerate(steps):
        pouts = prun(states, cols, n_local, ids)
        states = [p[0] for p in pouts]
        for r, (p, t) in enumerate(zip(pouts, touts)):
            nl = int(t[1].tree.n_leaf)
            _assert_same(p[0].assignment.boundaries.numpy(), t[0].assignment.boundaries, f"rank {r}: boundaries")
            _assert_same(p[1].tree.leaves[:nl + 1].numpy(), t[1].tree.leaves[:nl + 1], f"rank {r}: leaves")
            for f in ("halo_flags", "layout", "n_with_halos", "start_index", "end_index", "keys", "x", "h"):
                _assert_same(getattr(p[1], f).numpy(), getattr(t[1], f), f"rank {r}, step {s}: {f}")
            nwh = int(t[1].n_with_halos)
            _assert_same(p[5][:nwh].numpy(), t[5][:nwh], f"rank {r}, step {s}: halo ids")
