"""parallel/exchange.py and RankComm.all_to_all of the PyTorch port against
the JAX package's parallel/exchange.py (tests/test_exchange.py's cases):
the particle exchange round trip, replay_exchange and the range count and
sum services on 8 ranks (run_ranks threads against shard_map on the 8
virtual CPU devices), and pack_by_dest and _segment_fill on edge cases
(empty rows, invalid items, zero-length runs, overflow).

Tolerance: keys, payloads, records, counts and index streams bit-equal;
range sums, differences of float32 prefix sums accumulated in another
order than XLA's, within 4 ulps of the owner's total of JAX's and of a
float64 sum."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from cstone_tpu.parallel import exchange as jex
from cstone_tpu.parallel import make_mesh, rank_axis
from cstone_tpu_torch.ops.keys64 import from_numpy, to_numpy
from cstone_tpu_torch.parallel import exchange as tex
from cstone_tpu_torch.parallel import run_ranks
from tests.test_exchange import _make_particles
from tests.test_torch_domain import _assert_same

import torch_threads  # noqa: F401  (two intra-op threads per xdist worker)

R = 8
RK = np.uint64(1) << np.uint64(63)  # remove_key of 64-bit keys


def _jax_ranks(step, *arrays):
    """jit(shard_map(step)) over per-rank arrays (R, ...): the outputs,
    each stacked over the ranks."""
    mesh = make_mesh(R)
    sharding = NamedSharding(mesh, P(rank_axis))
    args = [jax.device_put(jnp.asarray(a.reshape((-1,) + a.shape[2:])), sharding) for a in arrays]

    def body(*a):
        return jax.tree.map(lambda v: jnp.asarray(v)[None], step(*a))

    return jax.block_until_ready(jax.jit(shard_map(body, mesh=mesh, in_specs=P(rank_axis), out_specs=P(rank_axis),
                                                   check_vma=False))(*args))


def _bounds(keys, n):
    bounds = np.zeros(R + 1, np.uint64)
    for i in range(1, R):
        bounds[i] = keys[int(i * n / R)]
    bounds[R] = RK
    return bounds


@pytest.mark.parametrize("seed, n, cap, move_cap", [(3, 2000, 800, 128), (7, 1600, 700, 96), (5, 2000, 800, 20)],
                         ids=["roundtrip", "replay", "move-overflow"])
def test_exchange_particles_and_replay_match_jax(seed, n, cap, move_cap):
    keys, lk, lv, n_per = _make_particles(seed, n, cap)
    bounds = _bounds(keys, n)

    def jstep(xl, vl):
        me = jax.lax.axis_index(rank_axis)
        nk, (nv,), rec = jex.exchange_particles(xl, (vl,), jnp.asarray(bounds), me, jnp.int32(n_per), move_cap,
                                                rank_axis)
        return nk, nv, jex.replay_exchange(vl, rec, rank_axis), rec

    jnk, jnv, jrep, jrec = _jax_ranks(jstep, lk, lv)

    def rank_fn(comm, k, v):
        nk, (nv,), rec = tex.exchange_particles(from_numpy(k), (torch.from_numpy(v),), from_numpy(bounds), comm.rank,
                                                n_per, move_cap, comm)
        return nk, nv, tex.replay_exchange(torch.from_numpy(v), rec, comm), rec

    total = 0
    for r, (nk, nv, rep, rec) in enumerate(run_ranks(R, rank_fn, list(lk), list(lv))):
        _assert_same(jnk[r], nk, f"rank {r}: keys")
        _assert_same(jnv[r], nv, f"rank {r}: payload")
        _assert_same(jrep[r], rep, f"rank {r}: replay_exchange")
        for f in ("send_idx", "send_valid", "merge_perm", "n_owned", "overflow"):
            _assert_same(getattr(jrec, f)[r], getattr(rec, f), f"rank {r}: record.{f}")
        no = int(rec.n_owned)
        if int(rec.overflow) == 0:
            # the rank holds exactly the particles of its key range, sorted,
            # the payload routed alongside, and the replay equals it
            expect = keys[(keys >= bounds[r]) & (keys < bounds[r + 1])]
            np.testing.assert_array_equal(to_numpy(nk[:no]), expect)
            np.testing.assert_array_equal(nv[:no].numpy(), (expect % 1000003).astype(np.float32))
            np.testing.assert_array_equal(rep[:no].numpy(), nv[:no].numpy())
            assert (to_numpy(nk[no:]) == RK).all()
        total += no
    overflow = [int(jrec.overflow[r]) for r in range(R)]
    if move_cap > 20:
        assert total == n and max(overflow) == 0
    else:
        assert max(overflow) > move_cap  # the largest single-destination send


def test_range_count_and_sum_services_match_jax():
    n, cap, Q, q_cap = 2400, 600, 64, 48
    rng = np.random.RandomState(11)
    keys = np.sort(rng.randint(0, 2**62, size=n).astype(np.uint64))
    vals = rng.uniform(0.1, 1.0, size=(n, 2)).astype(np.float32)
    n_per = n // R
    lk = np.full((R, cap), RK, np.uint64)
    lv = np.zeros((R, cap, 2), np.float32)
    bounds = np.zeros(R + 1, np.uint64)
    for r in range(R):
        lk[r, :n_per] = keys[r * n_per:(r + 1) * n_per]
        lv[r, :n_per] = vals[r * n_per:(r + 1) * n_per]
        bounds[r] = keys[r * n_per]
    bounds[0], bounds[R] = 0, RK
    # every rank asks Q ranges sorted by owner, a few of them invalid; q_cap
    # below the largest per-owner count, so some queries overflow
    qa, qb = np.zeros((R, Q), np.uint64), np.zeros((R, Q), np.uint64)
    dest = np.zeros((R, Q), np.int32)
    for r in range(R):
        a = rng.randint(0, 2**62, size=Q).astype(np.uint64)
        b = a + rng.randint(1, 2**55, size=Q).astype(np.uint64)
        d = np.searchsorted(bounds, a, side="right") - 1
        b = np.minimum(b, bounds[d + 1])
        order = np.argsort(d, kind="stable")
        qa[r], qb[r], dest[r] = a[order], b[order], d[order]
    dest[3, :] = 5  # rank 3 asks all of its ranges of rank 5: more than q_cap
    valid = rng.uniform(size=(R, Q)) > 0.1

    def jstep(lk, lv, qa, qb, d, v):
        counts, ovf1 = jex.range_count_service(qa, qb, d, v, lk, jnp.int32(n_per), R, q_cap, rank_axis)
        sums, ovf2 = jex.range_sum_service(qa, qb, d, v, lk, jnp.int32(n_per), lv, R, q_cap, rank_axis)
        return counts, ovf1, sums, ovf2

    jc, jo1, js, jo2 = _jax_ranks(jstep, lk, lv, qa, qb, dest, valid)

    def rank_fn(comm, k, v, a, b, d, ok):
        k, a, b = from_numpy(k), from_numpy(a), from_numpy(b)
        d, ok, v = torch.from_numpy(d), torch.from_numpy(ok), torch.from_numpy(v)
        counts, ovf1 = tex.range_count_service(a, b, d, ok, k, n_per, R, q_cap, comm)
        sums, ovf2 = tex.range_sum_service(a, b, d, ok, k, n_per, v, R, q_cap, comm)
        return counts, ovf1, sums, ovf2

    out = run_ranks(R, rank_fn, list(lk), list(lv), list(qa), list(qb), list(dest), list(valid))
    # a sum is the difference of two float32 prefix sums over the owner's
    # particles: within 4 ulps of the owner's total of a float64 sum
    owner_total = vals.astype(np.float64).reshape(R, n_per, 2).sum(1)
    for r, (counts, ovf1, sums, ovf2) in enumerate(out):
        _assert_same(jc[r], counts, f"rank {r}: counts")
        _assert_same(jo1[r], ovf1, f"rank {r}: count overflow")
        _assert_same(jo2[r], ovf2, f"rank {r}: sum overflow")
        col = np.array([(valid[r, :q] & (dest[r, :q] == dest[r, q])).sum() for q in range(Q)])
        served = valid[r] & (col < q_cap)
        atol = 4 * np.finfo(np.float32).eps * owner_total[dest[r]]
        assert (np.abs(sums.numpy() - np.asarray(js[r])) <= atol).all(), r
        for q in range(Q):
            d = dest[r, q]
            own = keys[d * n_per:(d + 1) * n_per]
            sel = (own >= qa[r, q]) & (own < qb[r, q])
            assert int(counts[q]) == (int(sel.sum()) if served[q] else 0), (r, q)
            want = vals[d * n_per:(d + 1) * n_per][sel].astype(np.float64).sum(0) if served[q] else 0.0
            assert (np.abs(sums[q].numpy() - want) <= atol[q]).all(), (r, q)
    assert int(out[3][1]) == int(valid[3].sum()) > q_cap and int(out[0][1]) == 0


@pytest.mark.parametrize("case", ["sorted", "empty-rows", "all-invalid"])
def test_pack_by_dest_matches_jax(case):
    rng = np.random.RandomState(2)
    n = 40
    dest = np.sort(rng.randint(0, R, size=n)).astype(np.int32)
    valid = rng.uniform(size=n) > 0.3
    if case == "empty-rows":
        dest = np.where(dest < 4, 1, 6).astype(np.int32)  # ranks 0, 2-5 and 7 get nothing
    if case == "all-invalid":
        valid[:] = False
    jrow, jcol = jex.pack_by_dest(jnp.asarray(dest), jnp.asarray(valid), R)
    row, col = tex.pack_by_dest(torch.from_numpy(dest), torch.from_numpy(valid), R)
    _assert_same(jrow, row, "row")
    np.testing.assert_array_equal(col.numpy()[valid], np.asarray(jcol)[valid])
    for d in range(R):
        sel = valid & (dest == d)
        np.testing.assert_array_equal(col.numpy()[sel], np.arange(sel.sum()))
    assert (row.numpy()[~valid] == R).all()


@pytest.mark.parametrize("case", ["fits", "empty-rows", "zero-runs", "overflow"])
def test_segment_fill_matches_jax(case):
    rng = np.random.RandomState(4)
    rows, K, out_cap = 5, 7, 24
    starts = rng.randint(0, 100, size=(rows, K)).astype(np.int32)
    lens = rng.randint(0, 5, size=(rows, K)).astype(np.int32)
    if case == "empty-rows":
        lens[[1, 3]] = 0
    if case == "zero-runs":
        lens[:, ::2] = 0
        lens[2, :] = -1  # negative lengths count as 0
    if case == "overflow":
        lens[4] = 6  # 42 > out_cap
    jidx, jvalid, jovf = jex._segment_fill(jnp.asarray(starts), jnp.asarray(lens), out_cap)
    idx, valid, ovf = tex._segment_fill(torch.from_numpy(starts).long(), torch.from_numpy(lens).long(), out_cap)
    _assert_same(jidx, idx, "idx")
    _assert_same(jvalid, valid, "valid")
    _assert_same(jovf, ovf, "overflow")
    for r in range(rows):  # the runs, concatenated and cut at out_cap
        want = np.concatenate([np.arange(s, s + max(n, 0)) for s, n in zip(starts[r], lens[r])] + [[]])
        want = want[:out_cap].astype(np.int64)
        np.testing.assert_array_equal(idx[r, :want.size].numpy(), want)
        assert int(valid[r].sum()) == want.size
    assert int(ovf) == (42 if case == "overflow" else 0)


@pytest.mark.parametrize("n_ranks", [1, 2, 8])
def test_all_to_all_rows(n_ranks):
    # row r of rank q's result is row q of rank r's input, in a fresh
    # tensor; at one rank it is the identity (of values)
    def rank_fn(comm):
        t = torch.arange(n_ranks * 3).reshape(n_ranks, 3) + 100 * comm.rank
        out = comm.all_to_all(t)
        return t, out

    out = run_ranks(n_ranks, rank_fn)
    for q, (t, got) in enumerate(out):
        assert got.shape == t.shape and got.data_ptr() != t.data_ptr()
        for r in range(n_ranks):
            torch.testing.assert_close(got[r], out[r][0][q], rtol=0, atol=0)
    if n_ranks == 1:
        torch.testing.assert_close(out[0][1], out[0][0], rtol=0, atol=0)
    with pytest.raises(ValueError, match="leading axis"):
        run_ranks(n_ranks, lambda comm: comm.all_to_all(torch.zeros(n_ranks + 1, 2)))
    x = torch.arange(4.0)[None]
    assert tex.all_to_all(x, None) is x
