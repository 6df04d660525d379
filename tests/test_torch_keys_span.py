"""Key math behind the focus tree in the PyTorch port against the JAX
package: trailing/leading zeros, last_nz_place, make_prefix, is_ancestor,
smallest_common_box, to_nbit_int_ceil, the spanSfcRange cover, and the
scan/segment primitives. Tolerance: bit-equal (keys compared as their
unsigned patterns)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cstone_tpu.ops import bits as jbits
from cstone_tpu.ops import primitives as jprim
from cstone_tpu.sfc import keys as jkeys
from cstone_tpu_torch.ops import bits, primitives
from cstone_tpu_torch.ops.keys64 import from_numpy, to_numpy, ule, ult
from cstone_tpu_torch.sfc import keys

import torch_threads  # noqa: F401  (two intra-op threads per xdist worker)

DTYPES = [np.uint32, np.uint64]


def _edge_keys(dt, seed=0, n=200):
    """Random keys of every magnitude plus the edges: 0, the end key,
    single cells, powers of 8 and their neighbours."""
    lmax = 10 if dt == np.uint32 else 21
    rng = np.random.RandomState(seed)
    end = 1 << (3 * lmax)
    ks = [0, 1, 7, 8, end, end - 1, end >> 3, (end >> 3) - 1, end // 2]
    ks += [1 << (3 * l) for l in range(lmax + 1)]
    ks += [int(rng.randint(0, 1 << 30)) << int(rng.randint(0, 3 * lmax - 29)) for _ in range(n)]
    ks += [(int(rng.randint(1, 8 ** 4)) << (3 * int(rng.randint(0, lmax - 3)))) for _ in range(n)]
    return np.array([k for k in ks if k <= end], dtype=dt)


@pytest.mark.parametrize("dt", DTYPES)
def test_bit_counts_match_jax(dt):
    k = np.concatenate([_edge_keys(dt), np.array([np.iinfo(dt).max, np.iinfo(dt).max - 1], dt)])
    t = from_numpy(k)
    np.testing.assert_array_equal(bits.count_trailing_zeros(t).numpy(),
                                  np.asarray(jbits.count_trailing_zeros(jnp.asarray(k))))
    np.testing.assert_array_equal(bits.count_leading_zeros(t).numpy(),
                                  np.asarray(jbits.count_leading_zeros(jnp.asarray(k))))


@pytest.mark.parametrize("dt", DTYPES)
def test_unsigned_compares(dt):
    k = _edge_keys(dt)
    a, b = np.meshgrid(k[:40], k[:40])
    ta, tb = from_numpy(a.copy()), from_numpy(b.copy())
    np.testing.assert_array_equal(ult(ta, tb).numpy(), a < b)
    np.testing.assert_array_equal(ule(ta, tb).numpy(), a <= b)
    end = int(k.max())
    signed_end = int(np.array(end, dt).view(np.int32 if dt == np.uint32 else np.int64))
    np.testing.assert_array_equal(ult(ta, signed_end).numpy(), a < end)
    np.testing.assert_array_equal(ule(signed_end, tb).numpy(), end <= b)


@pytest.mark.parametrize("dt", DTYPES)
def test_prefix_math_matches_jax(dt):
    k = _edge_keys(dt, seed=1)
    t, j = from_numpy(k), jnp.asarray(k)
    np.testing.assert_array_equal(keys.last_nz_place(t).numpy(), np.asarray(jkeys.last_nz_place(j)))
    np.testing.assert_array_equal(to_numpy(keys.make_prefix(t)), np.asarray(jkeys.make_prefix(j)))
    for pos in (0, 3, 10):
        assert keys.octal_power(dt, pos) == keys.node_range(dt, pos)
        np.testing.assert_array_equal(
            np.array(keys.octal_power(dt, pos)).astype(np.int64).view(np.uint64).astype(dt),
            np.asarray(jkeys.octal_power(dt, pos)))
    pos = torch.arange(0, 11)
    np.testing.assert_array_equal(to_numpy(keys.octal_power(dt, pos)),
                                  np.asarray(jkeys.octal_power(dt, jnp.arange(0, 11))))


@pytest.mark.parametrize("dt", DTYPES)
def test_common_box_and_ancestor_match_jax(dt):
    end = int(_edge_keys(dt).max())
    rng = np.random.RandomState(3)
    k = _edge_keys(dt, seed=2)
    k = k[k < end]
    k1, k2 = k[rng.permutation(len(k))], k[rng.permutation(len(k))]
    k2[:20] = k1[:20]  # equal keys: the smallest box is one cell
    lo, hi = keys.smallest_common_box(from_numpy(k1), from_numpy(k2))
    jlo, jhi = jkeys.smallest_common_box(jnp.asarray(k1), jnp.asarray(k2))
    np.testing.assert_array_equal(to_numpy(lo), np.asarray(jlo))
    np.testing.assert_array_equal(to_numpy(hi), np.asarray(jhi))

    p1, p2 = jkeys.make_prefix(jnp.asarray(k1)), jkeys.make_prefix(jnp.asarray(k2))
    p2 = jnp.where(jnp.arange(len(k1)) % 3 == 0, p1 >> 3, p2)  # real ancestors too
    got = keys.is_ancestor(from_numpy(np.asarray(p2)), from_numpy(np.asarray(p1)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jkeys.is_ancestor(p2, p1)))


@pytest.mark.parametrize("dt", DTYPES)
def test_to_nbit_int_ceil_matches_jax(dt):
    x = np.concatenate([np.random.RandomState(4).uniform(0, 1, 300), [0.0, 1.0, 0.5, 1e-9, 3.0]]).astype(np.float32)
    np.testing.assert_array_equal(keys.to_nbit_int_ceil(torch.from_numpy(x), dt).numpy(),
                                  np.asarray(jkeys.to_nbit_int_ceil(jnp.asarray(x), dt)))


def _span_pairs(dt, seed):
    k = np.unique(_edge_keys(dt, seed=seed))
    rng = np.random.RandomState(seed)
    a, b = k[rng.randint(0, len(k), 300)], k[rng.randint(0, len(k), 300)]
    a, b = np.minimum(a, b), np.maximum(a, b)
    end = k.max()
    # whole-range covers, single cells and empty ranges
    a = np.concatenate([a, np.array([0, 0, 8, end - 1, 5], dt)])
    b = np.concatenate([b, np.array([end, 1, 16, end, 5], dt)])
    return a, b


@pytest.mark.parametrize("dt", DTYPES)
def test_span_sfc_range_matches_jax(dt):
    a, b = _span_pairs(dt, 5)
    cap = 160
    jk, jn = jax.vmap(lambda x, y: jkeys.span_sfc_range(x, y, cap))(jnp.asarray(a), jnp.asarray(b))
    jc = jax.vmap(jkeys.span_sfc_range_count)(jnp.asarray(a), jnp.asarray(b))
    tk, tn = keys.span_sfc_range(from_numpy(a), from_numpy(b), cap)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(keys.span_sfc_range_count(from_numpy(a), from_numpy(b)).numpy(), np.asarray(jc))
    np.testing.assert_array_equal(to_numpy(tk), np.asarray(jk))
    # a capacity below the count truncates the same way
    jk, _ = jax.vmap(lambda x, y: jkeys.span_sfc_range(x, y, 7))(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(to_numpy(keys.span_sfc_range(from_numpy(a), from_numpy(b), 7)[0]), np.asarray(jk))


def test_span_sfc_range_golden(golden):
    # the reference implementation's vectors, as tests/test_sfc_keys.py reads them
    a = np.asarray(golden["span_a"], np.uint64)
    b = np.asarray(golden["span_b"], np.uint64)
    cnt = np.asarray(golden["span_count"])
    off = np.asarray(golden["span_offsets"])
    out = np.asarray(golden["span_out"], np.uint64)
    keys_t, n = keys.span_sfc_range(from_numpy(a), from_numpy(b), int(cnt.max()))
    np.testing.assert_array_equal(n.numpy(), cnt)
    got = to_numpy(keys_t)
    for i in range(len(a)):
        np.testing.assert_array_equal(got[i, :cnt[i]], out[off[i]:off[i] + cnt[i]])


def test_scan_and_segment_primitives_match_jax():
    rng = np.random.RandomState(6)
    x = rng.randint(0, 1 << 40, 500).astype(np.int64)
    np.testing.assert_array_equal(primitives.cumsum64(torch.from_numpy(x)).numpy(),
                                  np.asarray(jprim.cumsum64(jnp.asarray(x))))
    np.testing.assert_array_equal(primitives.exclusive_scan(torch.from_numpy(x)).numpy(),
                                  np.asarray(jprim.exclusive_scan(jnp.asarray(x))))
    n, nseg = 400, 37
    counts = rng.multinomial(n - 30, np.ones(nseg) / nseg)  # the last 30 elements lie past every segment
    counts[5] = counts[6] = 0  # empty segments
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    offsets[-1] = n + 50  # an offset past the end is dropped
    seg = primitives.segment_ids_from_offsets(torch.from_numpy(offsets), n, nseg)
    np.testing.assert_array_equal(seg.numpy(), np.asarray(jprim.segment_ids_from_offsets(jnp.asarray(offsets), n, nseg)))
    v = rng.uniform(0, 1, n).astype(np.float32)
    got = primitives.segment_max(torch.from_numpy(v), torch.from_numpy(offsets), nseg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jprim.segment_max(jnp.asarray(v), jnp.asarray(offsets), nseg)))
