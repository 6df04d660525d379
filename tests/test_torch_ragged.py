"""parallel/ragged.py and RankComm.ragged_all_to_all of the PyTorch port
against the JAX package's parallel/ragged.py on 8 ranks (run_ranks
threads against shard_map on the 8 virtual CPU devices, where JAX runs
its dense-padded emulation of jax.lax.ragged_all_to_all): the collective
on chunks with gaps, clamps at either end, zero sizes and rows the
chunks leave alone; the range count and sum services against JAX's and
a numpy oracle, with a total capacity that fits and one that overflows,
whose reported total makes the retry fit (tests/test_exchange_ragged.py's
cases); and the single-rank identity.

Tolerance: the collective's output, counts, overflows and every negotiated
size and offset bit-equal; range sums, differences of float32 prefix sums
accumulated in another order than XLA's, each within 4 ulps of the
owner's total of a float64 sum, and within twice that of each other."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cstone_tpu.parallel import ragged as jrg
from cstone_tpu.parallel import rank_axis
from cstone_tpu_torch.ops.keys64 import from_numpy
from cstone_tpu_torch.parallel import ragged as trg
from cstone_tpu_torch.parallel import run_ranks
from tests.test_exchange_ragged import _service_setup
from tests.test_torch_domain import _assert_same
from tests.test_torch_exchange import _jax_ranks

import torch_threads  # noqa: F401  (two intra-op threads per xdist worker)

R = 8
OUT_CAP, OP_LEN = 24, 20


def _a2a_case(case, seed=5):
    """Per-rank (R, ...) operand, input offsets, send sizes, output offsets
    and receive sizes: s[r, j] rows from rank r to rank j, laid out at
    every receiver in rank order."""
    rng = np.random.RandomState(seed)
    s = rng.randint(0, 4, size=(R, R)).astype(np.int32)
    if case == "zero-sizes":
        s[rng.uniform(size=(R, R)) < 0.6] = 0
        s[:, 2] = 0  # rank 2 receives nothing
        s[5] = 0  # rank 5 sends nothing
    in_off = np.concatenate([np.zeros((R, 1), np.int32), np.cumsum(s, 1)[:, :-1]], 1)
    gap = rng.randint(0, 3, size=(R, R)).astype(np.int32) if case in ("gaps", "clamped") else 0
    # out_off[r, j]: where rank r's chunk lands at rank j, after the chunks
    # of the ranks before r and the gaps in front of each
    out_off = np.cumsum(np.vstack([np.zeros((1, R), np.int32), (s + gap)[:-1]]), 0) + gap
    if case == "clamped":
        out_off[R - 1] = OUT_CAP - 1  # the last rank's chunks run past every receiver's end
        in_off[3, 4:] = OP_LEN - 1  # rank 3's last chunks start at its operand's last row
    recv = s.T.copy()
    operand = (np.arange(R)[:, None] * 1000 + np.arange(OP_LEN)[None, :]).astype(np.float32)
    if case == "rows":
        operand = np.stack([operand, -operand], axis=-1)
    return operand, in_off, s, out_off, recv


@pytest.mark.parametrize("case", ["contiguous", "gaps", "clamped", "zero-sizes", "rows"])
def test_ragged_all_to_all_matches_jax_emulation(case, monkeypatch):
    monkeypatch.setenv("CSTONE_RAGGED", "emulate")
    operand, in_off, s, out_off, recv = _a2a_case(case)
    tail = operand.shape[2:]

    def jstep(op, io, ss, oo, rs):
        out = jnp.full((OUT_CAP,) + tail, -1.0, jnp.float32)  # rows no chunk writes keep -1
        return jrg._ragged_a2a(op, out, io, ss, oo, rs, rank_axis)

    want = _jax_ranks(jstep, operand, in_off, s, out_off, recv)

    def rank_fn(comm, op, io, ss, oo, rs):
        out = torch.full((OUT_CAP,) + tail, -1.0)
        t = [torch.from_numpy(a) for a in (io, ss, oo, rs)]
        got = comm.ragged_all_to_all(torch.from_numpy(op), out, *t)
        assert (out == -1.0).all()  # a fresh tensor; output is left as it was
        return got

    got = run_ranks(R, rank_fn, list(operand), list(in_off), list(s), list(out_off), list(recv))
    for r in range(R):
        _assert_same(want[r], got[r], f"rank {r}")
    # by the contract: rank j's rows [out_off[r, j], +s[r, j]) hold rank r's
    # operand rows [in_off[r, j], +s[r, j]), cut at the output's end and
    # clamped at the operand's; every other row keeps -1
    for j in range(R):
        expect = np.full((OUT_CAP,) + tail, -1.0, np.float32)
        for r in range(R):
            for t in range(s[r, j]):
                if out_off[r, j] + t < OUT_CAP:
                    expect[out_off[r, j] + t] = operand[r, min(in_off[r, j] + t, OP_LEN - 1)]
        np.testing.assert_array_equal(got[j].numpy(), expect)


def test_ragged_all_to_all_checks_shapes():
    def rank_fn(comm):
        v = torch.zeros(R, dtype=torch.int64)
        with pytest.raises(ValueError, match="row shape and dtype"):
            comm.ragged_all_to_all(torch.zeros(4, 2), torch.zeros(4), v, v, v, v)
        with pytest.raises(ValueError, match=r"shape \(8,\)"):
            comm.ragged_all_to_all(torch.zeros(4), torch.zeros(4), v[:3], v, v, v)
        return True

    assert run_ranks(R, rank_fn) == [True] * R


def _jax_services(q_total_cap, setup):
    keys, vals, n_per, lk, lv, qa, qb, dest, valid = setup

    def jstep(lk, lv, qa, qb, d, v):
        cr, o1 = jrg.range_count_service_ragged(qa, qb, d, v, lk, jnp.int32(n_per), R, q_total_cap, rank_axis)
        sr, o2 = jrg.range_sum_service_ragged(qa, qb, d, v, lk, jnp.int32(n_per), lv, R, q_total_cap, rank_axis)
        perm, sizes, _ = jrg.compact_by_dest(d, v, R)
        meta = jrg.ragged_meta(sizes, q_total_cap, rank_axis)
        return cr, o1, sr, o2, meta

    return _jax_ranks(jstep, lk, lv, qa, qb, dest, valid)


def _port_services(q_total_cap, setup):
    keys, vals, n_per, lk, lv, qa, qb, dest, valid = setup

    def rank_fn(comm, k, v, a, b, d, ok):
        k, a, b = from_numpy(k), from_numpy(a), from_numpy(b)
        d, ok, v = torch.from_numpy(d), torch.from_numpy(ok), torch.from_numpy(v)
        cr, o1 = trg.range_count_service_ragged(a, b, d, ok, k, n_per, R, q_total_cap, comm)
        sr, o2 = trg.range_sum_service_ragged(a, b, d, ok, k, n_per, v, R, q_total_cap, comm)
        perm, sizes, _ = trg.compact_by_dest(d, ok, R)
        return cr, o1, sr, o2, trg.ragged_meta(sizes, q_total_cap, comm)

    return run_ranks(R, rank_fn, list(lk), list(lv), list(qa), list(qb), list(dest), list(valid))


def _check_against_jax(jout, out):
    jc, jo1, js, jo2, jmeta = jout
    for r, (cr, o1, sr, o2, meta) in enumerate(out):
        _assert_same(jc[r], cr, f"rank {r}: counts")
        _assert_same(jo1[r], o1, f"rank {r}: count overflow")
        _assert_same(jo2[r], o2, f"rank {r}: sum overflow")
        for f in ("input_offsets", "send_sizes", "output_offsets", "recv_sizes", "recv_offsets",
                  "ret_output_offsets", "overflow"):
            _assert_same(getattr(jmeta, f)[r], getattr(meta, f), f"rank {r}: meta.{f}")


def test_ragged_services_match_jax_and_oracle():
    setup = _service_setup()
    keys, vals, n_per, lk, lv, qa, qb, dest, valid = setup
    jout, out = _jax_services(512, setup), _port_services(512, setup)
    _check_against_jax(jout, out)
    js = jout[2]
    owner_total = vals.astype(np.float64).reshape(R, n_per, 2).sum(1)
    for r, (cr, o1, sr, o2, _) in enumerate(out):
        assert int(o1) == 0 and int(o2) == 0
        bound = 4 * np.finfo(np.float32).eps * owner_total[dest[r]]  # (Q, 2)
        assert (np.abs(sr.numpy() - np.asarray(js[r])) <= 2 * bound).all(), r
        for q in range(qa.shape[1]):
            if not valid[r, q]:
                assert int(cr[q]) == 0 and (sr[q] == 0).all()
                continue
            sel = (keys >= qa[r, q]) & (keys < qb[r, q])
            assert int(cr[q]) == int(sel.sum()), (r, q)
            want = vals[sel].astype(np.float64).sum(0)
            assert (np.abs(sr[q].numpy() - want) <= bound[q]).all(), (r, q)
            assert (np.abs(np.asarray(js[r][q]) - want) <= bound[q]).all(), (r, q)


def test_ragged_service_overflow_reports_required_total():
    # 64 queries a rank spread over 7 foreign ranks: a total capacity of 8
    # clamps every receiver, so the response leg lands with gaps; the
    # clamped results equal JAX's, and the reported unclamped total makes
    # the retry fit
    setup = _service_setup(seed=13, frac_valid=1.0)
    jout, out = _jax_services(8, setup), _port_services(8, setup)
    _check_against_jax(jout, out)
    ovf = max(int(o[1]) for o in out)
    assert ovf > 8
    # some requests were cut, and the response leg's offsets have gaps
    assert any(int(o[4].send_sizes.sum()) < int(setup[8][r].sum()) for r, o in enumerate(out))
    retry = _port_services(ovf, setup)
    assert max(int(o[1]) for o in retry) == 0
    _check_against_jax(_jax_services(ovf, setup), retry)


def test_single_rank_identity():
    # comm None: every function is the one-rank identity of the JAX package
    rng = np.random.RandomState(2)
    keys = np.sort(rng.randint(0, 2**62, size=50).astype(np.uint64))
    a = np.sort(rng.randint(0, 2**62, size=12).astype(np.uint64))
    b = a + np.uint64(2**58)
    valid = rng.uniform(size=12) > 0.3
    dest = np.zeros(12, np.int32)
    jc, jo = jrg.range_count_service_ragged(jnp.asarray(a), jnp.asarray(b), jnp.asarray(dest), jnp.asarray(valid),
                                            jnp.asarray(keys), jnp.int32(40), 1, 16, None)
    tc, to = trg.range_count_service_ragged(from_numpy(a), from_numpy(b), torch.from_numpy(dest),
                                            torch.from_numpy(valid), from_numpy(keys), 40, 1, 16, None)
    _assert_same(jc, tc, "counts")
    _assert_same(jo, to, "overflow")
    meta = trg.ragged_meta(torch.tensor([5]), 3, None)  # clamped at one rank too
    assert int(meta.overflow) == 5 and int(meta.recv_sizes[0]) == 3
    out = trg.ragged_send(torch.arange(5.0), 4, meta, None, fill=-1.0)
    np.testing.assert_array_equal(out.numpy(), [0.0, 1.0, 2.0, -1.0])
