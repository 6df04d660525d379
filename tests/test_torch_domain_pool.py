"""Pool-mode Domain of the PyTorch port on 8 ranks (parallel/comm.run_ranks,
one thread per rank) against the JAX package's pool mode inside shard_map
on the 8 virtual CPU devices: 8 ranks x 250 particles, buckets 16/8, tree
capacity 1024, focus capacity 2048, local capacity 1000, open and
periodic boxes.

Tolerance: every rank's SyncResult bit-equal slot for slot, over a cold
step and a warm step fed by compact_owned plus a drift; the pool branches
of exchange_halos and reapply_sync equal JAX's; the neighbour counts over
the owned slots sum to the brute-force total. The JAX step is jitted once
per box (a module-scope fixture), the carried state being one of its
inputs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

import cstone_tpu_torch
from cstone_tpu.domain.domain import Domain as JaxDomain
from cstone_tpu.parallel import make_mesh, rank_axis
from cstone_tpu.sfc import PERIODIC
from cstone_tpu.sfc import make_box as jax_make_box
from cstone_tpu_torch.domain import Domain
from cstone_tpu_torch.parallel import run_ranks
from cstone_tpu_torch.sfc import make_box
from cstone_tpu_torch.traversal.neighbors import _find_neighbors_impl
from tests.test_domain import brute_force_total
from tests.test_torch_domain import _assert_same

import torch_threads  # noqa: F401  (two intra-op threads per xdist worker)

R, N_PER, CAP = 8, 250, 1000
N = R * N_PER
KW = dict(bucket_size=16, bucket_size_focus=8, tree_capacity=1024, focus_capacity=2048)
RESULT_FIELDS = ("keys", "x", "y", "z", "h", "start_index", "end_index", "n_with_halos",
                 "layout", "halo_flags", "leaf_counts", "global_ids", "pool_perm", "sort_order",
                 "overflow")
STATE_FIELDS = ("focus_leaves", "focus_n", "box.limits", "assignment.boundaries",
                "assignment.counts", "global_tree.keys", "global_tree.counts", "global_tree.n_nodes",
                "linked.prefixes", "linked.child_offsets")


def _get(obj, path):
    for a in path.split("."):
        obj = getattr(obj, a)
    return obj


def stacked(tree):
    """Every leaf with a leading axis of length 1: shard_map stacks them."""
    return jax.tree.map(lambda a: jnp.asarray(a)[None], tree)


def rank_slice(tree, r):
    return jax.tree.map(lambda a: a[r], tree)


def jax_pool_step(periodic, grav=False, theta=0.5, mode="pool", **caps):
    """jit(shard_map) of one sync per rank (pool mode unless `mode` says
    otherwise; `caps` go to the Domain), the carried state an input:
    returns (state, result, compact-owned x/y/z/h/m and the owned count,
    reapply_sync and exchange_halos of the global particle id)."""
    mesh = make_mesh(R)
    jbox = jax_make_box(-1.0, 1.0, boundaries=PERIODIC if periodic else 0)

    def step(state, x, y, z, h, m, n_local, ids):
        state, n_local = jax.tree.map(lambda a: a[0], state), n_local[0]
        d = JaxDomain(rank=jax.lax.axis_index(rank_axis), n_ranks=R, key_dtype=jnp.uint64,
                      axis_name=rank_axis, exchange_mode=mode, protocol="dense", theta=theta, **KW, **caps)
        state, res = d.sync(state, x, y, z, h, properties=(m,), n_local=n_local, grav=grav)
        co = d.compact_owned
        moved = tuple(co(res, a) for a in (res.x, res.y, res.z, res.h, res.properties[0]))
        rids = d.reapply_sync(res, ids)
        j = jnp.arange(x.shape[0])
        owned = (j >= res.start_index) & (j < res.end_index)
        hids = d.exchange_halos(res, jnp.where(owned, rids, -1))
        out = (state, res, moved, res.end_index - res.start_index, rids, hids)
        return stacked(out)

    fn = jax.jit(shard_map(step, mesh=mesh, in_specs=P(rank_axis), out_specs=P(rank_axis),
                           check_vma=False))
    d0 = JaxDomain(rank=0, n_ranks=R, key_dtype=jnp.uint64, exchange_mode=mode, protocol="dense", **KW)
    state0 = d0.init_state(box=jbox if periodic else None, boundaries=jbox.boundaries)
    sharding = NamedSharding(mesh, P(rank_axis))

    def run(state, cols, n_local, ids):
        """state: stacked (R, ...) or None for the initial state; cols:
        (5, R, cap) float32 numpy x, y, z, h, m; n_local (R,)."""
        if state is None:
            state = jax.tree.map(lambda a: jnp.repeat(jnp.asarray(a)[None], R, axis=0), state0)
        put = lambda a: jax.device_put(jnp.asarray(a.reshape(-1) if a.ndim == 2 else a), sharding)  # noqa: E731
        args = [put(c) for c in cols] + [put(np.asarray(n_local, np.int32)), put(ids.astype(np.int32))]
        return jax.block_until_ready(fn(state, *args))

    return run


def port_pool_step(periodic, grav=False, theta=0.5, mode="pool", **caps):
    """The port's counterpart: run_ranks(R) of one sync per rank."""
    tbox = make_box(-1.0, 1.0, boundaries=PERIODIC if periodic else 0, device="cpu")

    def rank_fn(comm, state, cols, n_local, ids):
        d = Domain(exchange_mode=mode, comm=comm, theta=theta, device="cpu", **KW, **caps)
        if state is None:
            state = d.init_state(box=tbox if periodic else None, boundaries=tbox.boundaries)
        x, y, z, h, m = (torch.from_numpy(np.ascontiguousarray(c)) for c in cols)
        state, res = d.sync(state, x, y, z, h, properties=(m,), n_local=int(n_local), grav=grav)
        moved = tuple(d.compact_owned(res, a) for a in (res.x, res.y, res.z, res.h, res.properties[0]))
        rids = d.reapply_sync(res, torch.from_numpy(ids))
        j = torch.arange(x.shape[0])
        owned = (j >= res.start_index) & (j < res.end_index)
        hids = d.exchange_halos(res, torch.where(owned, rids, -1))
        return state, res, moved, res.end_index - res.start_index, rids, hids, d

    def run(states, cols, n_local, ids):
        return run_ranks(R, rank_fn, states or [None] * R, [cols[:, r] for r in range(R)],
                         list(n_local), list(ids))

    return run


def initial(seed=17, h_range=(0.03, 0.06), n_per=N_PER, cap=CAP):
    """Positions in [-1, 1)^3, each rank starting from a contiguous slice
    of n_per particles padded to cap: (5, R, cap) x, y, z, h, m, the
    global ids (R, cap), the (N, 3) positions and (N,) h."""
    n = R * n_per
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    h = rng.uniform(*h_range, size=n).astype(np.float32)
    m = rng.uniform(0.5, 1.5, size=n).astype(np.float32)
    cols = np.zeros((5, R, cap), np.float32)
    for c, a in enumerate((pos[:, 0], pos[:, 1], pos[:, 2], h, m)):
        cols[c, :, :n_per] = a.reshape(R, n_per)
    ids = np.full((R, cap), -1, np.int64)
    ids[:, :n_per] = np.arange(n).reshape(R, n_per)
    return cols, ids, pos, h


def drifted(moved, n_owned, periodic, seed):
    """The next step's per-rank input: the compact-owned columns plus a
    drift drawn on the host, and the ids of the owned particles."""
    rng = np.random.RandomState(seed)
    cols = np.stack([np.stack([np.asarray(moved[r][c]) for r in range(R)]) for c in range(5)])
    cols[:3] += rng.uniform(-0.02, 0.02, size=(3, R, CAP)).astype(np.float32)
    if periodic:
        cols[:3] = ((cols[:3] + 1.0) % 2.0 - 1.0).astype(np.float32)
    valid = np.arange(CAP)[None, :] < np.asarray(n_owned)[:, None]
    cols = np.where(valid[None], cols, 0.0).astype(np.float32)
    return cols


def assert_rank_same(jout, tout, r, leaves_only=()):
    """Rank r's results bit-equal; the fields in `leaves_only` over the
    tree's n_leaf leaves (their padding past n_leaf holds no leaf)."""
    js, jr = rank_slice(jout[0], r), rank_slice(jout[1], r)
    ts, tr = tout[0], tout[1]
    for f in RESULT_FIELDS:
        n = int(tr.tree.n_leaf) if f in leaves_only else None
        _assert_same(getattr(jr, f), getattr(tr, f), f"rank {r}: {f}", n)
    _assert_same(jr.properties[0], tr.properties[0], f"rank {r}: m")
    _assert_same(jr.tree.leaves, tr.tree.leaves, f"rank {r}: tree.leaves")
    _assert_same(jr.tree.n_leaf, tr.tree.n_leaf, f"rank {r}: tree.n_leaf")
    for f in STATE_FIELDS:
        _assert_same(_get(js, f), _get(ts, f), f"rank {r}: state.{f}")
    assert bool(js.focus_converged) == ts.focus_converged
    _assert_same(jout[4][r], tout[4], f"rank {r}: reapply_sync")
    _assert_same(jout[5][r], tout[5], f"rank {r}: exchange_halos")


@pytest.fixture(scope="module", params=[False, True], ids=["open", "periodic"])
def runs(request):
    periodic = request.param
    jrun, trun = jax_pool_step(periodic), port_pool_step(periodic)
    cols, ids, pos, h = initial()
    n_local = [N_PER] * R
    steps = []
    jstate, tstates = None, None
    for s in range(2):
        jout = jrun(jstate, cols, n_local, ids)
        touts = trun(tstates, cols, n_local, ids)
        steps.append((cols, n_local, jout, touts))
        jstate = jout[0]
        tstates = [t[0] for t in touts]
        n_local = [int(t[3]) for t in touts]
        # the owned ids travel with the particles: compact_owned of reapply_sync
        ids = np.stack([Domain.compact_owned(t[1], t[4]).numpy() for t in touts])
        ids = np.where(np.arange(CAP)[None] < np.asarray(n_local)[:, None], ids, -1)
        cols = drifted([t[2] for t in touts], n_local, periodic, seed=100 + s)
    return periodic, steps


@pytest.mark.parametrize("step", [0, 1], ids=["cold", "warm"])
def test_pool_sync_matches_jax_per_rank(runs, step):
    _, steps = runs
    _, _, jout, touts = steps[step]
    for r in range(R):
        assert_rank_same(jout, touts[r], r)
        assert int(touts[r][1].overflow) == 0
    assert sum(int(t[3]) for t in touts) == N


def test_pool_halo_fields_carry_owner_ids(runs):
    # every buffer slot, owned or halo, holds the id of the particle it is
    # a copy of: the id reapply_sync routed there, and exchange_halos fills
    # the halo slots with their owners' ids
    _, steps = runs
    cols, _, _, touts = steps[0]
    x_of_id = np.concatenate([cols[0, r, :N_PER] for r in range(R)])
    for comm_out in touts:
        res, rids, hids = comm_out[1], comm_out[4], comm_out[5]
        nwh = int(res.n_with_halos)
        np.testing.assert_array_equal(hids[:nwh].numpy(), rids[:nwh].numpy())
        assert (rids[:nwh] >= 0).all()
        np.testing.assert_array_equal(res.x[:nwh].numpy(), x_of_id[rids[:nwh].numpy()])


def test_pool_neighbor_sum_matches_brute_force(runs):
    periodic, steps = runs
    cols, n_local, _, touts = steps[1]
    pos = np.concatenate([cols[:3, r, :n].T for r, n in enumerate(n_local)])
    h = np.concatenate([cols[3, r, :n] for r, n in enumerate(n_local)])
    total = 0
    for t in touts:
        state, res = t[0], t[1]
        view = t[-1].ns_view(res, state.box)
        counts, _, stats = _find_neighbors_impl(
            res.x, res.y, res.z, res.h, view, state.box, ng_max=1, group_size=16,
            cand_leaf_cap=512, cand_cap=8192, chunk=8, with_indices=False, n_targets=CAP,
            frontier_cap=64)
        assert int(stats.cand_max) <= 8192 and int(stats.leaf_max) <= 512
        assert int(stats.frontier_max) <= 64
        total += int(counts[int(res.start_index):int(res.end_index)].sum())
    limits = touts[0][0].box.limits.numpy()
    assert total == brute_force_total(pos, h, limits, periodic)


def test_from_numpy_state_takes_one_rank(runs):
    _, steps = runs
    _, _, jout, touts = steps[1]
    for r in (0, R - 1):
        ts = cstone_tpu_torch.from_numpy_state(jout[0], device="cpu", rank=r)
        for f in STATE_FIELDS:
            _assert_same(_get(jout[0], f)[r], _get(ts, f), f"state.{f}")
        assert ts.first_call is False
        assert dataclasses.fields(ts) == dataclasses.fields(touts[r][0])


def expansion_centers_runs(mode, theta=0.6, n_per=200, cap=800, seed=61):
    """sync + update_expansion_centers on 8 ranks of n_per particles in
    exchange mode `mode`, by the JAX package (shard_map) and by the port
    (run_ranks), on the inputs of tests/test_expansion_centers.py. Returns
    (JAX, port), each per rank (leaves, n_leaf, leaf centers, leaf MAC
    spheres, MAC flags, the larger of the sync's and the centers'
    overflow, box limits), and the (n, 3) positions and (n,) masses."""
    n = R * n_per
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    h = rng.uniform(0.03, 0.06, size=n).astype(np.float32)
    m = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
    cols = np.zeros((5, R, cap), np.float32)
    for c, a in enumerate((pos[:, 0], pos[:, 1], pos[:, 2], h, m)):
        cols[c, :, :n_per] = a.reshape(R, n_per)

    def outputs(d, state, res, maximum):
        centers, spheres, flags, ovf = d.update_expansion_centers(state, res, res.properties[0])
        lo = res.tree.leaf_order()
        return (res.tree.leaves, res.tree.n_leaf, centers[lo], spheres[lo], flags, maximum(res.overflow, ovf),
                state.box.limits)

    mesh = make_mesh(R)
    jbox = jax_make_box(-1.0, 1.0)

    def step(x, y, z, h, m):
        d = JaxDomain(rank=jax.lax.axis_index(rank_axis), n_ranks=R, key_dtype=jnp.uint64, axis_name=rank_axis,
                      exchange_mode=mode, protocol="dense", theta=theta, **KW)
        state, res = d.sync(d.init_state(box=jbox, boundaries=jbox.boundaries), x, y, z, h, properties=(m,),
                            n_local=jnp.int32(n_per))
        return stacked(outputs(d, state, res, jnp.maximum))

    fn = jax.jit(shard_map(step, mesh=mesh, in_specs=P(rank_axis), out_specs=P(rank_axis), check_vma=False))
    sharding = NamedSharding(mesh, P(rank_axis))
    jout = jax.block_until_ready(fn(*(jax.device_put(jnp.asarray(c.reshape(-1)), sharding) for c in cols)))
    tbox = make_box(-1.0, 1.0, device="cpu")

    def rank_fn(comm, c):
        d = Domain(exchange_mode=mode, comm=comm, theta=theta, device="cpu", **KW)
        x, y, z, hh, mm = (torch.from_numpy(np.ascontiguousarray(a)) for a in c)
        state, res = d.sync(d.init_state(box=tbox, boundaries=tbox.boundaries), x, y, z, hh, properties=(mm,),
                            n_local=n_per)
        return outputs(d, state, res, torch.maximum)

    tout = run_ranks(R, rank_fn, [cols[:, r] for r in range(R)])
    return [rank_slice(jout, r) for r in range(R)], tout, pos, m


def assert_centers_match(jax_ranks, port_ranks, pos, m):
    """Leaves and MAC flags bit-equal. Centers: the foreign leaves' sums
    are differences of float32 prefix sums over the owner's particles,
    accumulated in another order than XLA's, so each side lies within the
    tolerances tests/test_expansion_centers.py holds JAX to against the
    float64 center of mass of every leaf's key range (masses rtol 2e-5,
    positions rtol 1e-4 and atol 2e-5), and the port's centers and MAC
    spheres within twice those of JAX's (each ~1.5e-5 from the oracle,
    on opposite sides at some leaves)."""
    from cstone_tpu_torch.ops.keys64 import to_numpy
    from cstone_tpu_torch.sfc.box import Box
    from cstone_tpu_torch.sfc.encode import HILBERT, compute_sfc_keys
    from tests.test_expansion_centers import _oracle_centers

    p = torch.from_numpy(pos)
    for r, (j, t) in enumerate(zip(jax_ranks, port_ranks)):
        leaves, n_leaf, centers, spheres, flags, ovf, limits = t
        nl = int(n_leaf)
        assert int(ovf) == 0 and nl == int(j[1])
        _assert_same(j[0], leaves, f"rank {r}: leaves")
        _assert_same(j[4], flags, f"rank {r}: mac flags", nl)
        keys = to_numpy(compute_sfc_keys(p[:, 0], p[:, 1], p[:, 2], Box(limits=limits, boundaries=(0, 0, 0)),
                                         np.uint64, HILBERT))
        oracle = _oracle_centers(to_numpy(leaves), nl, keys, pos, m)
        sel = oracle[:, 3] > 0
        for name, got in (("port", centers[:nl].numpy()), ("JAX", np.asarray(j[2])[:nl])):
            np.testing.assert_allclose(got[:, 3], oracle[:, 3], rtol=2e-5, err_msg=f"rank {r}: {name} mass")
            np.testing.assert_allclose(got[sel, :3], oracle[sel, :3], rtol=1e-4, atol=2e-5,
                                       err_msg=f"rank {r}: {name} centers")
        for name, got, want in (("centers", centers, j[2]), ("spheres", spheres, j[3])):
            got, want = got[:nl].numpy(), np.asarray(want)[:nl]
            np.testing.assert_allclose(got[:, :3], want[:, :3], rtol=2e-4, atol=4e-5, err_msg=f"rank {r}: {name}")
            np.testing.assert_allclose(got[:, 3], want[:, 3], rtol=4e-5 if name == "centers" else 2e-4,
                                       atol=0 if name == "centers" else 4e-5, err_msg=f"rank {r}: {name}")
        assert float(centers[:nl, 3].sum()) == pytest.approx(float(m.astype(np.float64).sum()), rel=1e-5)


def test_update_expansion_centers_on_pool_ranks_matches_jax():
    # foreign leaves are summed by their owners' range-sum service
    assert_centers_match(*expansion_centers_runs("pool"))


@pytest.mark.parametrize("periodic", [False, True], ids=["open", "periodic"])
def test_global_bounds_and_octree_match_jax(periodic):
    # parallel/global_tree.py: the box over all ranks and the cornerstone
    # tree of all ranks' sorted keys, each rank holding n_per of cap slots
    from cstone_tpu.parallel.global_tree import compute_global_octree as jax_octree
    from cstone_tpu.parallel.global_tree import global_bounds as jax_bounds
    from cstone_tpu_torch.ops.keys64 import from_numpy, to_numpy
    from cstone_tpu_torch.parallel import compute_global_octree, global_bounds

    rng = np.random.RandomState(5)
    cap, n_per = 64, 50
    keys = np.sort(rng.randint(0, 1 << 62, size=(R, cap), dtype=np.int64).astype(np.uint64) * np.uint64(2), axis=1)
    xyz = rng.uniform(-1, 1, size=(3, R, cap)).astype(np.float32)
    jbox = jax_make_box(-1.0, 1.0, boundaries=PERIODIC if periodic else 0)
    mesh = make_mesh(R)

    def step(k, x, y, z):
        tree = jax_octree(k, 8, 256, rank_axis, n_codes=n_per)
        box = jax_bounds(x, y, z, rank_axis, prev_box=jbox)
        return tree.keys[None], tree.counts[None], tree.n_nodes[None], box.limits[None]

    fn = jax.jit(shard_map(step, mesh=mesh, in_specs=P(rank_axis), out_specs=P(rank_axis), check_vma=False))
    jk, jc, jn, jl = fn(jnp.asarray(keys.reshape(-1)), *(jnp.asarray(c.reshape(-1)) for c in xyz))
    tbox = make_box(-1.0, 1.0, boundaries=PERIODIC if periodic else 0, device="cpu")

    def rank_fn(comm, k, x, y, z):
        tree = compute_global_octree(from_numpy(k), 8, 256, comm, n_codes=n_per)
        box = global_bounds(*(torch.from_numpy(c) for c in (x, y, z)), comm, prev_box=tbox)
        return tree, box

    out = run_ranks(R, rank_fn, list(keys), *(list(c) for c in xyz))
    for r, (tree, box) in enumerate(out):
        nn = int(tree.n_nodes)
        assert nn == int(jn[r]) > 8
        np.testing.assert_array_equal(to_numpy(tree.keys), np.asarray(jk[r]))
        np.testing.assert_array_equal(tree.counts.numpy(), np.asarray(jc[r]))
        assert int(tree.counts[:nn].sum()) == R * n_per
        np.testing.assert_array_equal(box.limits.numpy(), np.asarray(jl[r]))


def sph_ranks_match_one_rank(route, mode):
    """sph_density_step on 8 ranks of Domain(exchange_mode=mode) equals the
    one-rank density of the same particles: the halos arrive with x, y, z,
    h and m (float sums in another order: rtol 1e-5)."""
    from cstone_tpu_torch.models import SphState, sph_density_step

    cols, ids, pos, h = initial(seed=7)
    kw = dict(cell_level=4, cell_cap=64) if route == "cell" else dict(ng_max=128, group_size=16, cand_leaf_cap=512, cand_cap=8192)
    tbox = make_box(-1.0, 1.0, boundaries=PERIODIC, device="cpu")
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731

    one = Domain(exchange_mode=mode, device="cpu", **KW)
    state = SphState(domain=one.init_state(box=tbox, boundaries=tbox.boundaries),
                     x=t(pos[:, 0]), y=t(pos[:, 1]), z=t(pos[:, 2]), h=t(h),
                     m=t(np.concatenate([cols[4, r, :N_PER] for r in range(R)])), n_local=torch.tensor(N))
    _, rho_one, res_one = sph_density_step(one, state, **kw)
    assert int(res_one.overflow) == 0
    want = np.empty(N, np.float32)
    want[res_one.sort_order[:N].numpy()] = rho_one[:N].numpy()

    def rank_fn(comm, c, i):
        d = Domain(exchange_mode=mode, comm=comm, device="cpu", **KW)
        s = SphState(domain=d.init_state(box=tbox, boundaries=tbox.boundaries), x=t(c[0]), y=t(c[1]),
                     z=t(c[2]), h=t(c[3]), m=t(c[4]), n_local=torch.tensor(N_PER))
        _, rho, res = sph_density_step(d, s, **kw)
        rid = d.reapply_sync(res, t(i))
        return res, rho, rid

    got = np.full(N, np.nan, np.float32)
    for res, rho, rid in run_ranks(R, rank_fn, [cols[:, r] for r in range(R)], list(ids)):
        assert int(res.overflow) == 0
        s, e = int(res.start_index), int(res.end_index)
        got[rid[s:e].numpy()] = rho[s:e].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("route", ["cell", "tree"])
def test_sph_density_step_on_pool_ranks_matches_one_rank(route):
    sph_ranks_match_one_rank(route, "pool")
