"""syncGrav and update_expansion_centers of the PyTorch port on 8 ranks in
the two p2p routes the grav tests of the dense protocol leave out: the
ragged protocol (parallel/ragged.py, range_sum_service_ragged) and the
dense protocol over a peer window (parallel/exchange.py's windowed
services, range_sum_service(window=W)), against the JAX package inside
shard_map on the 8 virtual CPU devices.

8 ranks x 200 particles (tests/test_torch_domain_pool.initial(seed=29),
the inputs of tests/test_torch_domain_p2p_grav.py), theta 0.5, local
capacity n, buckets 16/8, a cold step and a warm step fed by the port's
compact_owned particles plus a drift; each sync followed by
update_expansion_centers, in the same shard_map program on the JAX side.

- ragged: every rank's SyncResult bit-equal slot for slot, the particle
  exchange record, the ragged halo record and its negotiated meta
  included, the halo flags over the tree's leaves (past n_leaf JAX's grav
  flags read the MAC mark of the node its unstable sort left in
  leaf_to_internal's padding, the port's stay 0);
- peer_window = R - 1: the same, the windowed halo record included;
- peer_window = 1, below the need: both packages report the same
  7-entry overflow_detail (slot 6 the window the halo owners and MAC
  peers need, R - 1), and the port's sync_with_retry from window 1 then
  equals the full-window run;
- update_expansion_centers in both routes: leaves, assignment and MAC
  flags bit-equal; at the cold step centres and MAC spheres within the
  tolerances of tests/test_torch_domain_pool.assert_centers_match (the
  foreign leaves' sums are float32 prefix-sum differences, accumulated in
  another order than XLA's); at both steps every leaf centre of both
  packages within grav_ranks.OUTSIDE_UNITS (16) rounding units of the
  float64 centre of mass of its particles (leaf_rounding_units), the bound
  the chip runs hold the port to. At the ragged warm step one foreign
  leaf's mass lies 2.3e-5 of itself off the oracle, above
  assert_centers_match's rtol 2e-5 on the mass, yet 0.15 rounding units
  off: a small leaf far into its owner's prefix sums, so that step is
  held by the rounding-unit bound alone."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from cstone_tpu.domain.domain import Domain as JaxDomain
from cstone_tpu.parallel import make_mesh, rank_axis
from cstone_tpu.sfc import make_box as jax_make_box
from cstone_tpu_torch import grav_ranks as gr
from cstone_tpu_torch.domain import Domain, sync_with_retry
from cstone_tpu_torch.ops.keys64 import to_numpy
from cstone_tpu_torch.parallel import run_ranks
from cstone_tpu_torch.parallel.ragged import RaggedHaloRecord
from cstone_tpu_torch.sfc import make_box
from cstone_tpu_torch.sfc.box import Box
from cstone_tpu_torch.sfc.encode import HILBERT, compute_sfc_keys
from tests.test_torch_domain import _assert_same
from tests.test_torch_domain_p2p import EX_FIELDS, RESULT_FIELDS, assert_p2p_rank_same
from tests.test_torch_domain_pool import KW, R, STATE_FIELDS, _get, assert_centers_match, initial, rank_slice, stacked
from tests.test_torch_domain_ragged import HALO_FIELDS as RAGGED_HALO_FIELDS
from tests.test_torch_domain_ragged import META_FIELDS

import torch_threads  # noqa: F401  (two intra-op threads per xdist worker)

N_PER = 200
CAP = R * N_PER
THETA = 0.5
ROUTES = {"ragged": dict(protocol="ragged"), "window": dict(protocol="dense", peer_window=R - 1)}


def _centres(d, state, res, maximum):
    """assert_centers_match's per-rank tuple of update_expansion_centers."""
    centers, spheres, flags, ovf = d.update_expansion_centers(state, res, res.properties[0])
    lo = res.tree.leaf_order()
    return (res.tree.leaves, res.tree.n_leaf, centers[lo], spheres[lo], flags, maximum(res.overflow, ovf),
            state.box.limits)


def jax_grav_step(sync_only=False, **route):
    """jit(shard_map) of one p2p syncGrav per rank in `route` (protocol,
    peer_window), then update_expansion_centers: returns run(state, cols,
    n_local, ids) -> stacked (state, result, compact-owned x/y/z/h/m, the
    owned count, reapply_sync and exchange_halos of the particle id, the
    centres' tuple); with sync_only (state, result), a smaller program."""
    mesh = make_mesh(R)
    jbox = jax_make_box(-1.0, 1.0)

    def step(state, x, y, z, h, m, n_local, ids):
        state, n_local = jax.tree.map(lambda a: a[0], state), n_local[0]
        d = JaxDomain(rank=jax.lax.axis_index(rank_axis), n_ranks=R, key_dtype=jnp.uint64, axis_name=rank_axis,
                      exchange_mode="p2p", theta=THETA, **KW, **route)
        state, res = d.sync(state, x, y, z, h, properties=(m,), n_local=n_local, grav=True)
        if sync_only:
            return stacked((state, res))
        moved = tuple(d.compact_owned(res, a) for a in (res.x, res.y, res.z, res.h, res.properties[0]))
        rids = d.reapply_sync(res, ids)
        j = jnp.arange(x.shape[0])
        hids = d.exchange_halos(res, jnp.where((j >= res.start_index) & (j < res.end_index), rids, -1))
        return stacked((state, res, moved, res.end_index - res.start_index, rids, hids,
                        _centres(d, state, res, jnp.maximum)))

    fn = jax.jit(shard_map(step, mesh=mesh, in_specs=P(rank_axis), out_specs=P(rank_axis), check_vma=False))
    state0 = JaxDomain(rank=0, n_ranks=R, key_dtype=jnp.uint64, exchange_mode="p2p", **KW).init_state(
        box=jbox, boundaries=jbox.boundaries)
    sharding = NamedSharding(mesh, P(rank_axis))

    def run(state, cols, n_local, ids):
        put = lambda a: jax.device_put(jnp.asarray(a.reshape(-1) if a.ndim == 2 else a), sharding)  # noqa: E731
        if state is None:  # laid out as the carried state is, so that the warm step runs the same executable
            state = jax.tree.map(lambda a: jax.device_put(jnp.repeat(jnp.asarray(a)[None], R, axis=0), sharding),
                                 state0)
        args = [put(c) for c in cols] + [put(np.asarray(n_local, np.int32)), put(ids.astype(np.int32))]
        return jax.block_until_ready(fn(state, *args))

    return run


def _port_rank(comm, state, c, n_local, ids, route):
    d = Domain(exchange_mode="p2p", comm=comm, theta=THETA, device="cpu", **KW, **route)
    tbox = make_box(-1.0, 1.0, device="cpu")
    if state is None:
        state = d.init_state(box=tbox, boundaries=tbox.boundaries)
    x, y, z, h, m = (torch.from_numpy(np.ascontiguousarray(a)) for a in c)
    state, res = d.sync(state, x, y, z, h, properties=(m,), n_local=int(n_local), grav=True)
    moved = tuple(d.compact_owned(res, a) for a in (res.x, res.y, res.z, res.h, res.properties[0]))
    rids = d.reapply_sync(res, torch.from_numpy(ids))
    j = torch.arange(x.shape[0])
    hids = d.exchange_halos(res, torch.where((j >= res.start_index) & (j < res.end_index), rids, -1))
    return state, res, moved, res.end_index - res.start_index, rids, hids, _centres(d, state, res, torch.maximum)


def _drifted(moved, n_owned, seed):
    """The next step's per-rank input: the compact-owned columns plus a
    drift drawn on the host (tests/test_torch_domain_pool.drifted at this
    capacity, open box)."""
    rng = np.random.RandomState(seed)
    cols = np.stack([np.stack([np.asarray(moved[r][c]) for r in range(R)]) for c in range(5)])
    cols[:3] += rng.uniform(-0.02, 0.02, size=(3, R, CAP)).astype(np.float32)
    valid = np.arange(CAP)[None, :] < np.asarray(n_owned)[:, None]
    return np.where(valid[None], cols, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=None)
def run_steps(name, n_steps=2):
    """Per step (cols, n_local, JAX outputs, port outputs per rank) of
    ROUTES[name], both sides fed the port's compact-owned particles plus
    one drift; computed once a module."""
    route = ROUTES[name]
    jrun = jax_grav_step(**route)
    cols, ids, _, _ = initial(seed=29, n_per=N_PER, cap=CAP)
    n_local = [N_PER] * R
    steps, jstate, tstates = [], None, None
    for s in range(n_steps):
        jout = jrun(jstate, cols, n_local, ids)
        touts = run_ranks(R, _port_rank, tstates or [None] * R, [cols[:, r] for r in range(R)], n_local, list(ids),
                          [route] * R)
        steps.append((cols, n_local, jout, touts))
        jstate, tstates = jout[0], [t[0] for t in touts]
        n_local = [int(t[3]) for t in touts]
        ids = np.stack([Domain.compact_owned(t[1], t[4]).numpy() for t in touts])
        ids = np.where(np.arange(CAP)[None] < np.asarray(n_local)[:, None], ids, -1)
        cols = _drifted([t[2] for t in touts], n_local, seed=100 + s)
    return steps


def assert_ragged_grav_rank_same(jout, tout, r):
    """Rank r's ragged syncGrav bit-equal to JAX's, records included, the
    halo flags over the tree's leaves."""
    js, jr = rank_slice(jout[0], r), rank_slice(jout[1], r)
    ts, tr = tout[0], tout[1]
    for f in RESULT_FIELDS:
        n = int(tr.tree.n_leaf) if f == "halo_flags" else None
        _assert_same(getattr(jr, f), getattr(tr, f), f"rank {r}: {f}", n)
    _assert_same(jr.properties[0], tr.properties[0], f"rank {r}: m")
    _assert_same(jr.tree.leaves, tr.tree.leaves, f"rank {r}: tree.leaves")
    _assert_same(jr.tree.n_leaf, tr.tree.n_leaf, f"rank {r}: tree.n_leaf")
    for f in EX_FIELDS:
        _assert_same(getattr(jr.ex_record, f), getattr(tr.ex_record, f), f"rank {r}: ex_record.{f}")
    assert isinstance(tr.halo_record, RaggedHaloRecord)
    assert tr.halo_record.halo_total_cap == jr.halo_record.halo_total_cap
    for f in RAGGED_HALO_FIELDS:
        _assert_same(getattr(jr.halo_record, f), getattr(tr.halo_record, f), f"rank {r}: halo_record.{f}")
    for f in META_FIELDS:
        _assert_same(getattr(jr.halo_record.meta, f), getattr(tr.halo_record.meta, f),
                     f"rank {r}: halo_record.meta.{f}")
    for f in STATE_FIELDS:
        _assert_same(_get(js, f), _get(ts, f), f"rank {r}: state.{f}")
    assert bool(js.focus_converged) == ts.focus_converged
    _assert_same(jout[4][r], tout[4], f"rank {r}: reapply_sync")
    _assert_same(jout[5][r], tout[5], f"rank {r}: exchange_halos")


@pytest.fixture(scope="module", params=list(ROUTES))
def runs(request):
    return request.param, run_steps(request.param)


@pytest.mark.parametrize("step", [0, 1], ids=["cold", "warm"])
def test_grav_sync_matches_jax_per_rank(runs, step):
    name, steps = runs
    _, _, jout, touts = steps[step]
    for r in range(R):
        if name == "ragged":
            assert_ragged_grav_rank_same(jout, touts[r], r)
        else:
            assert_p2p_rank_same(jout, touts[r], r, leaves_only=("halo_flags",))
            assert touts[r][1].halo_record.window == R - 1
        res = touts[r][1]
        assert int(res.overflow) == 0
        assert not res.halo_flags[int(res.tree.n_leaf):].any()
    assert sum(int(t[3]) for t in touts) == R * N_PER


def leaf_rounding_units(centres: tuple, boundaries, rank: int, pos: np.ndarray, m: np.ndarray) -> np.ndarray:
    """(n_leaf, 2) gaps of a rank's leaf centres (x, y, z, mass; a tuple
    of _centres) to the float64 centre of mass of the leaf's particles,
    beyond grav_ranks.CENTER_RTOL, in units of the bound that float32
    rounding puts on the sums that made them (grav_ranks.rounding_units):
    a foreign leaf's sums are differences of its owner's float32 prefix
    sums, each off by up to eps32 x the owner's prefix sum of |values| at
    the leaf's two ends; an own leaf's by up to eps32 x its sum of
    |values|. `boundaries`: the rank's assignment."""
    leaves, n_leaf, centers, _, _, _, limits = (np.array(a) for a in centres)
    if isinstance(centres[0], torch.Tensor):  # the port's 64-bit keys are int64 bit patterns
        leaves = to_numpy(centres[0])
    nl = int(n_leaf)
    p = torch.from_numpy(pos)
    keys = to_numpy(compute_sfc_keys(p[:, 0], p[:, 1], p[:, 2], Box(limits=torch.from_numpy(limits),
                                                                     boundaries=(0, 0, 0)), np.uint64, HILBERT))
    order = np.argsort(keys, kind="stable")
    ks, w = keys[order], np.abs(m[order])
    vals = np.stack([w * pos[order, 0], w * pos[order, 1], w * pos[order, 2], w], axis=1).astype(np.float32)
    scan, acc = (np.concatenate([np.zeros((1, 4)), np.cumsum(v.astype(np.float64), axis=0)])
                 for v in (vals, np.abs(vals)))
    a, b = leaves[:nl], leaves[1:nl + 1]
    bounds = np.asarray(boundaries)
    lo, hi, seg = (np.searchsorted(ks, q) for q in (a, b, bounds))
    owner = np.clip(np.searchsorted(bounds, a, side="right") - 1, 0, R - 1)
    base = acc[seg[owner]]
    eps = float(np.finfo(np.float32).eps)
    err = eps * np.where((owner != rank)[:, None], acc[lo] - base + acc[hi] - base, acc[hi] - acc[lo])
    sums = scan[hi] - scan[lo]
    mass = sums[:, 3:]
    want = np.concatenate([sums[:, :3] / np.where(mass != 0, mass, 1.0), mass], axis=1)
    level = 21 - np.log2((b - a).astype(np.float64)) / 3  # a leaf spans 8^(21 - level) 64-bit keys
    side = ((limits[1::2] - limits[0::2])[None, :] / 2.0 ** level[:, None]).astype(np.float64)
    return gr.rounding_units(torch.from_numpy(centers[:nl]), torch.from_numpy(want), torch.from_numpy(err),
                             torch.from_numpy(side)).numpy()


@pytest.mark.parametrize("step", [0, 1], ids=["cold", "warm"])
def test_expansion_centres_match_jax(runs, step):
    # foreign leaves are summed by their owners' range-sum service, ragged
    # or over the window
    _, steps = runs
    cols, n_local, jout, touts = steps[step]
    pos = np.concatenate([cols[:3, r, :n_local[r]].T for r in range(R)])
    m = np.concatenate([cols[4, r, :n_local[r]] for r in range(R)])
    jax_ranks, port_ranks = [rank_slice(jout[6], r) for r in range(R)], [t[6] for t in touts]
    if step == 0:
        assert_centers_match(jax_ranks, port_ranks, pos, m)
    units = []
    for r, (j, t) in enumerate(zip(jax_ranks, port_ranks)):
        nl = int(t[1])
        assert int(t[5]) == 0 and nl == int(j[1])
        _assert_same(j[0], t[0], f"rank {r}: leaves")
        _assert_same(j[4], t[4], f"rank {r}: mac flags", nl)
        bounds = touts[r][0].assignment.boundaries
        _assert_same(rank_slice(jout[0], r).assignment.boundaries, bounds, f"rank {r}: assignment")
        for name, c in (("port", t), ("JAX", j)):
            u = leaf_rounding_units(c, to_numpy(bounds), r, pos, m)
            units.append(float(u.max()))
            assert u.max() <= gr.OUTSIDE_UNITS, f"rank {r}: {name} leaf centres {u.max()} rounding units off"
    assert max(units) > 0


def test_window_below_the_need_reports_it_and_the_retry_equals_the_full_window():
    cols, ids, _, _ = initial(seed=29, n_per=N_PER, cap=CAP)
    n_local = [N_PER] * R
    narrow = jax_grav_step(sync_only=True, protocol="dense", peer_window=1)(None, cols, n_local, ids)
    full = run_steps("window")[0][2]
    got = run_ranks(R, _port_rank, [None] * R, [cols[:, r] for r in range(R)], n_local, list(ids),
                    [dict(protocol="dense", peer_window=1)] * R)
    for r in range(R):
        _assert_same(rank_slice(narrow[1], r).overflow_detail, got[r][1].overflow_detail, f"rank {r}: detail")
        assert got[r][1].overflow_detail.tolist()[6] == R - 1

    def retried(comm, c, n, i):
        def once(caps):
            out = _port_rank(comm, None, c, n, i, dict(protocol="dense", peer_window=caps["window"]))
            return out, out[1]  # sync_with_retry reads the last element's overflow

        (out, _), caps = sync_with_retry(once, {"window": 1})
        return out, caps

    for r, (out, caps) in enumerate(run_ranks(R, retried, [cols[:, r] for r in range(R)], n_local, list(ids))):
        res = out[1]
        assert caps["window"] > R - 1 and int(res.overflow) == 0 and res.halo_record.window == R - 1
        assert_p2p_rank_same(full, out, r, leaves_only=("halo_flags",))
