"""The peer-window protocol of the PyTorch port (Domain(peer_window=W):
parallel/exchange.py's windowed services and halo exchange over
RankComm.ppermute) against the JAX package, the port's ranks as run_ranks
threads, JAX's inside shard_map on the 8 virtual CPU devices:

- collectives: RankComm.ppermute against jax.lax.ppermute on a ring and
  a one-way shift; windowed_exchange and dest_to_window_row at 8 ranks
  and W in {1, 3, 7};
- services: range_count_service, range_sum_service, build_halo_exchange
  and exchange_halo_field with window=W against JAX's with the same W,
  and at W = R-1 equal to the port's dense protocol;
- the Domain (tests/test_domain_window.py): the flagship, 8 ranks of 250
  on a 16x1x1 slab with the window grown from 1 by overflow_detail[6],
  every rank's SyncResult, halo record (2W+1 rows) and overflow detail
  equal to JAX's at every attempt, the converged neighbour sum equal to
  brute force; a full-width window equal to the dense protocol; one rank
  with a window equal to none (the window is clipped to 0, as in JAX);
  sync_with_retry growing "window" as JAX's does;
- DistComm.ppermute and the windowed Domain on gloo processes
  (spawn_ranks) equal to run_ranks.

Tolerance: exact, except the range sums: each is the difference of two
float32 prefix sums over the owner's particles, accumulated in another
order than XLA's, and is held within 4 ulps of the owner's total (as in
tests/test_torch_exchange.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from cstone_tpu.domain.domain import Domain as JaxDomain
from cstone_tpu.domain.domain import sync_with_retry as jax_sync_with_retry
from cstone_tpu.parallel import exchange as jex
from cstone_tpu.parallel import make_mesh, rank_axis
from cstone_tpu.sfc import make_box as jax_make_box
from cstone_tpu_torch.domain import CAP_NAMES, Domain, sync_with_retry
from cstone_tpu_torch.domain.layout import compute_node_layout
from cstone_tpu_torch.ops.keys64 import from_numpy
from cstone_tpu_torch.parallel import exchange as tex
from cstone_tpu_torch.parallel import run_ranks
from cstone_tpu_torch.parallel.dist import spawn_ranks
from cstone_tpu_torch.sfc import make_box
from cstone_tpu_torch.tree import compute_octree
from tests.test_domain import brute_force_total
from tests.test_torch_domain import _assert_same
from tests.test_torch_domain_p2p import owned_neighbor_count
from tests.test_torch_exchange import _jax_ranks

import torch_dist_ranks as ranks
import torch_threads  # noqa: F401  (two intra-op threads per xdist worker)

R = 8
RK = np.uint64(1) << np.uint64(63)  # remove_key of 64-bit keys
WINDOWS = [1, 3, 7]


def _stack(tree):
    return jax.tree.map(lambda a: jnp.asarray(a)[None], tree)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", ["ring", "shift"])
def test_ppermute_matches_jax(shape):
    pairs = [(r, (r + 1) % R) for r in range(R)] if shape == "ring" else [(r, r + 3) for r in range(R - 3)]
    x = np.random.RandomState(1).uniform(-1, 1, size=(R, 5, 2)).astype(np.float32)
    want = _jax_ranks(lambda a: jax.lax.ppermute(a[None], rank_axis, pairs)[0], x)
    got = run_ranks(R, lambda comm, a: comm.ppermute(torch.from_numpy(a), pairs), list(x))
    for r in range(R):
        _assert_same(want[r], got[r], f"rank {r}")
    if shape == "shift":
        assert all(not got[r].any() for r in range(3))  # no rank sends to ranks 0-2


@pytest.mark.parametrize("W", WINDOWS)
def test_windowed_exchange_and_rows_match_jax(W):
    rng = np.random.RandomState(2 + W)
    buf = rng.randint(-100, 100, size=(R, 2 * W + 1, 3)).astype(np.int32)
    dest = rng.randint(-1, R + 1, size=(R, 40)).astype(np.int32)

    def jstep(b, d):
        me = jax.lax.axis_index(rank_axis)
        row, inw = jex.dest_to_window_row(d, me, W, R)
        return jex.windowed_exchange(b, rank_axis, W, R), row, inw

    jout, jrow, jin = _jax_ranks(jstep, buf, dest)

    def rank_fn(comm, b, d):
        row, inw = tex.dest_to_window_row(torch.from_numpy(d), comm.rank, W, R)
        return tex.windowed_exchange(torch.from_numpy(b), comm, W, R), row, inw

    for r, (out, row, inw) in enumerate(run_ranks(R, rank_fn, list(buf), list(dest))):
        _assert_same(jout[r], out, f"rank {r}: windowed_exchange")
        _assert_same(jrow[r], row, f"rank {r}: rows")
        _assert_same(jin[r], inw, f"rank {r}: in window")
        for w in range(2 * W + 1):  # row w comes from rank r + w - W, or is zero
            src = r + w - W
            want = buf[src, 2 * W - w] if 0 <= src < R else np.zeros(3, np.int32)
            np.testing.assert_array_equal(out[w].numpy(), want)
    one = torch.from_numpy(buf[0])
    assert tex.windowed_exchange(one, None, W, R) is one  # one rank: the buffer itself
    with pytest.raises(ValueError, match="rows"):
        tex.windowed_exchange(torch.zeros(2 * W, 3), None, W, R)


# ---------------------------------------------------------------------------
# services
# ---------------------------------------------------------------------------

def _service_case(seed=11, n=2400, cap=600, bucket=24):
    """Per-rank sorted keys and values; a global tree whose leaf starts
    are the rank boundaries; per rank, the tree's leaves with exact
    counts, its own leaf range, a random request of foreign leaves and
    the layout of own and requested leaves."""
    rng = np.random.RandomState(seed)
    keys = np.sort(rng.randint(0, 2**62, size=n).astype(np.uint64) * np.uint64(2))
    tree = compute_octree(from_numpy(keys), bucket, capacity=1024)
    nl = int(tree.n_nodes)
    leaves = tree.keys.numpy().view(np.uint64)
    lcounts = tree.counts.numpy()
    bounds = np.array([leaves[(r * nl) // R] for r in range(R)] + [RK], np.uint64)
    owner = np.clip(np.searchsorted(bounds, leaves[:-1], side="right") - 1, 0, R - 1).astype(np.int32)
    lk = np.full((R, cap), RK, np.uint64)
    lv = np.zeros((R, cap, 2), np.float32)
    n_own = np.zeros(R, np.int32)
    for r in range(R):
        mine = keys[(keys >= bounds[r]) & (keys < bounds[r + 1])]
        n_own[r] = mine.size
        lk[r, :mine.size] = mine
        lv[r, :mine.size, 0] = (mine % np.uint64(1000003)).astype(np.float32)
        lv[r, :mine.size, 1] = rng.uniform(0.1, 1.0, mine.size)
    li = np.arange(leaves.size - 1)
    valid = li < nl
    req = np.stack([valid & (owner != r) & (rng.uniform(size=li.size) < 0.3) for r in range(R)])
    layout = np.stack([compute_node_layout(torch.from_numpy(lcounts), torch.from_numpy(req[r]),
                                           int((owner < r).sum()), int((owner <= r).sum())).numpy()
                       for r in range(R)])
    return dict(lk=lk, lv=lv, n_own=n_own, leaves=leaves, lcounts=lcounts, owner=owner, valid=valid, req=req,
                layout=layout)


@pytest.mark.parametrize("W", WINDOWS)
def test_windowed_services_match_jax(W):
    c = _service_case()
    q_cap, req_cap, halo_cap = 64, 48, 400
    Rb = lambda a: np.broadcast_to(a, (R,) + a.shape).copy()  # noqa: E731
    a, b = c["leaves"][:-1], c["leaves"][1:]
    qvalid = np.stack([c["valid"] & (c["owner"] != r) for r in range(R)])
    args = (c["lk"], c["lv"], c["n_own"], Rb(a), Rb(b), Rb(c["owner"]), qvalid, c["req"], c["layout"].astype(np.int32),
            Rb(c["lcounts"].astype(np.int32)))

    def jstep(lk, lv, n_own, a, b, owner, qv, req, layout, lcounts):
        me = jax.lax.axis_index(rank_axis)
        n_own = n_own[0]
        counts, o1 = jex.range_count_service(a, b, owner, qv, lk, n_own, R, q_cap, rank_axis, my_rank=me, window=W)
        sums, o2 = jex.range_sum_service(a, b, owner, qv, lk, n_own, lv, R, q_cap, rank_axis, my_rank=me, window=W)
        rec = jex.build_halo_exchange(a, b, lcounts.astype(jnp.uint32), layout, req, owner, lk, n_own, R, req_cap,
                                      halo_cap, rank_axis, my_rank=me, window=W)
        filled = jex.exchange_halo_field(lv[:, 0], jnp.zeros(lk.shape[0] * 2, jnp.float32), rec, rank_axis)
        return counts, o1, sums, o2, rec, filled

    jc, jo1, js, jo2, jrec, jfill = _jax_ranks(jstep, *args)
    assert jrec.window == W

    def rank_fn(comm, lk, lv, n_own, a, b, owner, qv, req, layout, lcounts, window):
        t = torch.from_numpy
        lk, a, b, lv = from_numpy(lk), from_numpy(a), from_numpy(b), t(lv)
        owner, qv, req, layout, lcounts = (t(np.ascontiguousarray(v)) for v in (owner, qv, req, layout, lcounts))
        n_own = int(n_own)
        kw = dict(my_rank=comm.rank, window=window)
        counts, o1 = tex.range_count_service(a, b, owner, qv, lk, n_own, R, q_cap, comm, **kw)
        sums, o2 = tex.range_sum_service(a, b, owner, qv, lk, n_own, lv, R, q_cap, comm, **kw)
        rec = tex.build_halo_exchange(a, b, lcounts, layout, req, owner, lk, n_own, R, req_cap, halo_cap, comm, **kw)
        filled = tex.exchange_halo_field(lv[:, 0], torch.zeros(lk.shape[0] * 2), rec, comm)
        return counts, o1, sums, o2, rec, filled

    owner_total = c["lv"].astype(np.float64).sum(1)  # (R, 2)
    per_rank = [list(v) for v in args]
    got = run_ranks(R, rank_fn, *per_rank, [W] * R)
    for r, (counts, o1, sums, o2, rec, filled) in enumerate(got):
        _assert_same(jc[r], counts, f"rank {r}: counts")
        _assert_same(jo1[r], o1, f"rank {r}: count overflow")
        _assert_same(jo2[r], o2, f"rank {r}: sum overflow")
        # a sum is the difference of two float32 prefix sums over the
        # owner's particles: within 4 ulps of the owner's total
        atol = 4 * np.finfo(np.float32).eps * owner_total[c["owner"]]
        assert (np.abs(sums.numpy() - np.asarray(js[r])) <= atol).all(), r
        assert rec.window == W and rec.n_ranks == R and rec.send_idx.shape == (2 * W + 1, halo_cap)
        for f in ("send_idx", "send_valid", "recv_idx", "recv_valid", "overflow"):
            _assert_same(getattr(jrec, f)[r], getattr(rec, f), f"rank {r}: record.{f}")
        _assert_same(jfill[r], filled, f"rank {r}: exchange_halo_field")
    # queries to owners outside the window count 0
    r = 0
    far = qvalid[r] & (np.abs(c["owner"] - r) > W)
    assert (got[r][0].numpy()[far] == 0).all() and (W == R - 1 or far.any())
    if W == R - 1:
        dense = run_ranks(R, rank_fn, *per_rank, [None] * R)
        for r in range(R):
            for k, (x, y) in enumerate(zip(got[r], dense[r])):
                if k == 4:
                    for f in ("send_valid", "recv_valid", "overflow"):
                        assert int(getattr(x, f).sum()) == int(getattr(y, f).sum()), f
                else:
                    assert torch.equal(x, y), (r, k)


# ---------------------------------------------------------------------------
# the Domain
# ---------------------------------------------------------------------------

KW = dict(bucket_size=16, bucket_size_focus=8, tree_capacity=1024, focus_capacity=2048)
SLAB = (0.0, 16.0, 0.0, 1.0, 0.0, 1.0)
RESULT_FIELDS = ("keys", "x", "y", "z", "h", "start_index", "end_index", "n_with_halos", "layout", "halo_flags",
                 "leaf_counts", "sort_order", "overflow", "overflow_detail")
HALO_FIELDS = ("send_idx", "send_valid", "recv_idx", "recv_valid", "overflow")


def _slab(n_ranks=R, n_per=250, seed=17):
    """tests/test_domain_window.py's particles: a 16x1x1 slab, h in
    [0.05, 0.09], rank r starting from the r-th slice of n_per."""
    rng = np.random.RandomState(seed)
    n = n_ranks * n_per
    pos = rng.uniform(0.0, 1.0, size=(n, 3)).astype(np.float32)
    pos[:, 0] *= 16.0
    h = rng.uniform(0.05, 0.09, size=n).astype(np.float32)
    cols = np.zeros((4, n_ranks, 4 * n_per), np.float32)
    cols[:3, :, :n_per] = pos.T.reshape(3, n_ranks, n_per)
    cols[3, :, :n_per] = h.reshape(n_ranks, n_per)
    return cols, pos, h


def _jax_sync(cols, n_per, window):
    """One JAX sync a rank inside shard_map: (state, result), stacked."""
    mesh = make_mesh(R)
    jbox = jax_make_box(*SLAB)

    def step(x, y, z, h):
        d = JaxDomain(rank=jax.lax.axis_index(rank_axis), n_ranks=R, key_dtype=jnp.uint64, axis_name=rank_axis,
                      peer_window=window, protocol="dense", **KW)
        return _stack(d.sync(d.init_state(box=jbox, boundaries=jbox.boundaries), x, y, z, h,
                             n_local=jnp.int32(n_per)))

    fn = jax.jit(shard_map(step, mesh=mesh, in_specs=P(rank_axis), out_specs=P(rank_axis), check_vma=False))
    sharding = NamedSharding(mesh, P(rank_axis))
    return jax.block_until_ready(fn(*(jax.device_put(jnp.asarray(c.reshape(-1)), sharding) for c in cols)))


def _port_sync(cols, n_per, window, n_ranks=R):
    """The port's counterpart: per rank (domain, state, result)."""
    box = make_box(*SLAB, device="cpu")

    def rank_fn(comm, c):
        d = Domain(comm=comm, device="cpu", peer_window=window, **KW)
        state, res = d.sync(d.init_state(box=box, boundaries=box.boundaries), *torch.from_numpy(c), n_local=n_per)
        return d, state, res

    return run_ranks(n_ranks, rank_fn, [np.ascontiguousarray(cols[:, r]) for r in range(n_ranks)])


def test_domain_window_flagship_8ranks():
    cols, pos, h = _slab()
    window, attempts = 1, []
    for _ in range(4):
        jstate, jres = _jax_sync(cols, 250, window)
        out = _port_sync(cols, 250, window)
        detail = out[0][2].overflow_detail.tolist()
        attempts.append((window, detail))
        for r, (d, state, res) in enumerate(out):
            assert d.peer_window == window
            for f in RESULT_FIELDS:
                _assert_same(getattr(jres, f)[r], getattr(res, f), f"W={window}, rank {r}: {f}")
            _assert_same(jres.tree.leaves[r], res.tree.leaves, f"W={window}, rank {r}: focus leaves")
            rec, jrec = res.halo_record, jres.halo_record
            assert rec.window == jrec.window == window and rec.send_idx.shape[0] == 2 * window + 1
            for f in HALO_FIELDS:
                _assert_same(getattr(jrec, f)[r], getattr(rec, f), f"W={window}, rank {r}: halo_record.{f}")
        if int(out[0][2].overflow) == 0:
            break
        assert detail[6] > window, f"an overflow without a window report: {attempts}"
        window = detail[6]
    else:
        raise AssertionError(f"the window never converged: {attempts}")
    assert len(attempts) > 1, "the window did not grow"
    assert sum(int(res.end_index) - int(res.start_index) for _, _, res in out) == pos.shape[0]
    total = sum(owned_neighbor_count(d, state, res) for d, state, res in out)
    assert total == brute_force_total(pos, h, np.asarray(SLAB), False)


def test_window_full_width_matches_dense():
    # tests/test_domain_window.py's second case, 4 ranks of 200 in
    # [-1, 1]^3: W = R-1 reaches every rank, so it equals the dense protocol
    n_ranks, n_per = 4, 200
    rng = np.random.RandomState(31)
    pos = rng.uniform(-1, 1, size=(n_ranks * n_per, 3)).astype(np.float32)
    h = rng.uniform(0.04, 0.08, size=n_ranks * n_per).astype(np.float32)
    box = make_box(-1.0, 1.0, device="cpu")

    def rank_fn(comm, window):
        sl = slice(comm.rank * n_per, (comm.rank + 1) * n_per)
        c = np.zeros((4, 4 * n_per), np.float32)
        c[:3, :n_per], c[3, :n_per] = pos[sl].T, h[sl]
        d = Domain(comm=comm, device="cpu", peer_window=window, **KW)
        state, res = d.sync(d.init_state(box=box, boundaries=box.boundaries), *torch.from_numpy(c), n_local=n_per)
        return d, state, res

    wide = run_ranks(n_ranks, rank_fn, [n_ranks - 1] * n_ranks)
    dense = run_ranks(n_ranks, rank_fn, [0] * n_ranks)
    for r, ((_, _, w), (_, _, d)) in enumerate(zip(wide, dense)):
        assert w.halo_record.window == n_ranks - 1 and w.halo_record.send_idx.shape[0] == 2 * n_ranks - 1
        assert d.halo_record.window is None and d.halo_record.send_idx.shape[0] == n_ranks
        assert int(w.overflow) == 0
        for f in RESULT_FIELDS:
            assert torch.equal(getattr(w, f), getattr(d, f)), f"rank {r}: {f}"
    total = sum(owned_neighbor_count(*o) for o in wide)
    assert total == brute_force_total(pos, h, box.limits.numpy(), False)


def test_one_rank_window_is_clipped_to_none():
    # at one rank JAX clips the window to min(W, R-1) = 0 and runs; so does the port
    _, pos, h = _slab(n_ranks=1, n_per=600)
    box = make_box(*SLAB, device="cpu")
    out = []
    for window in (3, 0):
        d = Domain(n_ranks=1, device="cpu", peer_window=window, **KW)
        assert d.peer_window == 0
        t = torch.from_numpy(np.ascontiguousarray(pos.T))
        out.append(d.sync(d.init_state(box=box, boundaries=box.boundaries), *t, torch.from_numpy(h))[1])
    for f in RESULT_FIELDS:
        assert torch.equal(getattr(out[0], f), getattr(out[1], f)), f
    assert out[0].overflow_detail[6] == 0
    with pytest.raises(ValueError, match="dense"):
        Domain(n_ranks=2, comm=None, device="cpu", protocol="ragged", peer_window=1)


def test_sync_with_retry_grows_the_window_as_jax():
    # the host loops of both packages on the same reported overflows: the
    # window jumps to need + 8 (JAX's rule), which the Domain then clips to
    # R - 1; a last overflow raises
    def fake(detail_of, box):
        seen = []

        def run(caps):
            seen.append(dict(caps))
            d = np.asarray(detail_of(caps), np.int64)
            return box(np.asarray(d.max()), d)

        return run, seen

    def detail_of(caps):
        return [0, 0, 0, 0, 0, 0, 7 if caps["window"] < 7 else 0]

    caps0 = {k: 0 for k in CAP_NAMES}
    caps0.update(local=1000, tree=1024, focus=2048, window=1)

    class JRes:
        def __init__(self, ovf, d):
            self.overflow, self.overflow_detail = ovf, d

    def tres(ovf, d):
        return JRes(torch.tensor(ovf), torch.from_numpy(d))

    jrun, jseen = fake(detail_of, JRes)
    trun, tseen = fake(detail_of, tres)
    (_, jcaps), (_, tcaps) = jax_sync_with_retry(jrun, caps0), sync_with_retry(trun, caps0)
    assert tseen == jseen and tcaps == jcaps and [c["window"] for c in tseen] == [1, 15]

    # and on the Domain, inside run_ranks: 4 ranks of the slab, W from 1
    cols, pos, h = _slab(n_ranks=4)
    box = make_box(*SLAB, device="cpu")

    def rank_fn(comm, c):
        def run(caps):
            d = Domain(comm=comm, device="cpu", peer_window=caps["window"], **KW)
            state, res = d.sync(d.init_state(box=box, boundaries=box.boundaries), *torch.from_numpy(c), n_local=250)
            return d, state, res

        return sync_with_retry(run, dict(caps0, window=1))

    out = run_ranks(4, rank_fn, [np.ascontiguousarray(cols[:, r]) for r in range(4)])
    for (d, state, res), caps in out:
        assert caps["window"] > 1 and d.peer_window == 3 and int(res.overflow) == 0
    total = sum(owned_neighbor_count(*o) for o, _ in out)
    assert total == brute_force_total(pos, h, np.asarray(SLAB), False)


# ---------------------------------------------------------------------------
# processes
# ---------------------------------------------------------------------------

def test_ppermute_and_windowed_domain_on_processes():
    n = 4
    cols, ids = ranks.initial(n)
    modes = (("p2p", "dense", 1), ("p2p", "dense", n - 1))
    args = ([cols[:, r] for r in range(n)], list(ids), [True] * n, [modes] * n)
    gloo = dict(backend="gloo", device="cpu", timeout=30.0, deadline=240.0)
    want = run_ranks(n, ranks.ppermutes, [5] * n), run_ranks(n, ranks.domain_steps, *args)
    got = spawn_ranks(n, ranks.ppermutes, [5] * n, **gloo), spawn_ranks(n, ranks.domain_steps, *args, **gloo)
    for w, g in zip(want, got):
        for r in range(n):
            assert w[r].keys() == g[r].keys()
            for k, v in w[r].items():
                if isinstance(v, dict):
                    assert v.keys() == g[r][k].keys()
                    for f, t in v.items():
                        assert t.dtype == g[r][k][f].dtype and torch.equal(t, g[r][k][f]), (r, k, f)
                else:
                    assert v.dtype == g[r][k].dtype and torch.equal(v, g[r][k]), (r, k)
    sent = [torch.randn(3, 2, generator=torch.Generator().manual_seed(5 + r)) for r in range(n)]
    for r, p in enumerate(want[0]):
        assert torch.equal(p["ring"], sent[(r - 1) % n]) and not p["none"].any()
        assert torch.equal(p["shift"], sent[r - 1] if r else torch.zeros(3, 2))
    assert "p2p-dense-w1-1" in want[1][0] and want[1][0]["p2p-dense-w3-1"]["result.overflow"] == 0
