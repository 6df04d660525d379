"""The last leaf modules of the PyTorch port against the JAX package, on
seeded inputs, 32- and 64-bit keys, Morton and Hilbert where a function
takes a curve:

- domain/decomposition.py: create_send_offsets, translate_assignment,
  initial_domain_splits;
- tree/csarray.py: find_node_below, find_node_above, update_treelet_ops,
  compute_spanning_tree (also against the reference's golden vectors);
- tree/btree.py (build_binary_tree) and tree/continuum.py (the same
  concentration written once in jnp and once in torch);
- the sfc leftovers of keys.py, encode.py, box.py and hilbert.py;
- traversal/celllist.stencil_stats;
- focus/exchange_focus.exchange_focus_quantities at 8 ranks (run_ranks
  threads against shard_map on the 8 virtual CPU devices);
- native/, the host C++ oracle, held against the port's own encode and
  tree build as tests/test_native.py holds the JAX package's (skipped with
  a reason where it does not build).

Tolerance: bit-equal everywhere; the continuum counts are float sums
rounded to integers, and equal after the rounding."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from cstone_tpu.domain import decomposition as jdec
from cstone_tpu.focus.exchange_focus import exchange_focus_quantities as jax_exchange_focus
from cstone_tpu.parallel import make_mesh, rank_axis
from cstone_tpu.sfc import box as jbox
from cstone_tpu.sfc import encode as jenc
from cstone_tpu.sfc import hilbert as jhil
from cstone_tpu.sfc import keys as jkeys
from cstone_tpu.traversal import celllist as jcell
from cstone_tpu.tree import btree as jbt
from cstone_tpu.tree import continuum as jcont
from cstone_tpu.tree import csarray as jcs
from cstone_tpu_torch import native
from cstone_tpu_torch.domain import decomposition as tdec
from cstone_tpu_torch.focus.exchange_focus import exchange_focus_quantities
from cstone_tpu_torch.ops.keys64 import from_numpy, to_numpy
from cstone_tpu_torch.parallel import run_ranks
from cstone_tpu_torch.sfc import box as tbox
from cstone_tpu_torch.sfc import encode as tenc
from cstone_tpu_torch.sfc import hilbert as thil
from cstone_tpu_torch.sfc import keys as tkeys
from cstone_tpu_torch.traversal import celllist as tcell
from cstone_tpu_torch.tree import btree as tbt
from cstone_tpu_torch.tree import continuum as tcont
from cstone_tpu_torch.tree import csarray as tcs
from tests.test_torch_domain import _assert_same

import torch_threads  # noqa: F401  (two intra-op threads per xdist worker)

DTYPES = [np.uint32, np.uint64]
CURVES = [jenc.MORTON, jenc.HILBERT]
LMAX = {np.uint32: 10, np.uint64: 21}


def _end(dt):
    return dt(1) << dt(3 * LMAX[dt])


def _random_keys(rng, dt, n):
    """n random keys below 2^(3 maxLevel), with 0 and the end key among them."""
    k = (rng.randint(0, 2**62, size=n).astype(np.uint64) % np.uint64(_end(dt))).astype(dt)
    k[:2] = [0, _end(dt)]
    return k


def _random_tree(rng, dt, n_keys=300, bucket=4):
    """A cornerstone tree over random keys: (keys (n+1,), counts (n,))."""
    keys = np.sort(_random_keys(rng, dt, n_keys)[:-1])
    tree = jcs.compute_octree(jnp.asarray(keys), bucket)
    n = int(tree.n_nodes)
    return np.asarray(tree.keys), np.asarray(tree.counts), n


def _ibox_same(jb, tb, name):
    for f in ("xmin", "xmax", "ymin", "ymax", "zmin", "zmax"):
        _assert_same(getattr(jb, f), getattr(tb, f), f"{name}.{f}")


# ---------------------------------------------------------------------------
# decomposition helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", DTYPES, ids=["u32", "u64"])
def test_decomposition_helpers_match_jax(dt):
    rng = np.random.RandomState(21)
    R = 6
    keys, counts, n = _random_tree(rng, dt)
    ja = jdec.make_sfc_assignment(jnp.asarray(keys), jnp.asarray(counts), n, R)
    ta = tdec.make_sfc_assignment(from_numpy(keys), torch.from_numpy(counts.astype(np.int64)), n, R)
    _assert_same(ja.boundaries, ta.boundaries, "boundaries")

    particles = np.sort(_random_keys(rng, dt, 400)[:-1])
    for n_part in (None, 250):
        _assert_same(jdec.create_send_offsets(ja, jnp.asarray(particles), n_part),
                     tdec.create_send_offsets(ta, from_numpy(particles), n_part), f"send offsets, n={n_part}")

    peers = rng.uniform(size=R) > 0.5
    for me in (0, 3, R - 1):
        js, je = jdec.translate_assignment(ja, jnp.asarray(keys), jnp.int32(n), jnp.asarray(peers), me)
        ts, te = tdec.translate_assignment(ta, from_numpy(keys), n, torch.from_numpy(peers), me)
        _assert_same(js, ts, f"starts, rank {me}")
        _assert_same(je, te, f"ends, rank {me}")
        assert int(ts[me]) <= int(te[me])

    for n_ranks, level in ((1, 0), (5, 2), (8, 3), (7, LMAX[dt])):
        want = jdec.initial_domain_splits(n_ranks, level, dt)
        got = tdec.initial_domain_splits(n_ranks, level, dt)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# csarray leftovers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", DTYPES, ids=["u32", "u64"])
def test_find_node_and_treelet_ops_match_jax(dt):
    rng = np.random.RandomState(22)
    keys, counts, n = _random_tree(rng, dt)
    probe = np.concatenate([_random_keys(rng, dt, 200), keys[:n + 1]])
    for fn in ("find_node_below", "find_node_above"):
        _assert_same(getattr(jcs, fn)(jnp.asarray(keys), jnp.int32(n), jnp.asarray(probe)),
                     getattr(tcs, fn)(from_numpy(keys), n, from_numpy(probe)), fn)
    # a treelet: the first 40 leaves of the tree with counts around the bucket
    tk = np.full(65, keys[40], dt)
    tk[:41] = keys[:41]
    tc = rng.randint(0, 40, size=64).astype(np.uint32)
    tc[40:] = 0
    jops, jconv = jcs.update_treelet_ops(jnp.asarray(tk), jnp.asarray(tc), jnp.int32(40), 16)
    tops, tconv = tcs.update_treelet_ops(from_numpy(tk), torch.from_numpy(tc.astype(np.int64)), 40, 16)
    _assert_same(jops, tops, "treelet ops")
    assert bool(jconv) == bool(tconv)


def test_spanning_tree_golden(golden):
    splits = golden["spanning_splits"]
    keys, n = tcs.compute_spanning_tree(from_numpy(splits), splits.shape[0] - 1, 2048)
    np.testing.assert_array_equal(to_numpy(keys[:int(n) + 1]), golden["spanning_tree"])
    jkeys_, jn = jcs.compute_spanning_tree(jnp.asarray(splits), jnp.int32(splits.shape[0] - 1), 2048)
    _assert_same(jkeys_, keys, "spanning tree keys")
    assert int(jn) == int(n)


@pytest.mark.parametrize("dt", DTYPES, ids=["u32", "u64"])
def test_spanning_tree_matches_jax(dt):
    rng = np.random.RandomState(23)
    m, n_splits, cap = 9, 6, 1536
    inner = np.sort(_random_keys(rng, dt, 40)[2:2 + n_splits - 1])
    splits = np.full(m + 1, _end(dt), dt)
    splits[0] = 0
    splits[1:n_splits] = inner
    jk, jn = jcs.compute_spanning_tree(jnp.asarray(splits), jnp.int32(n_splits), cap)
    tk, tn = tcs.compute_spanning_tree(from_numpy(splits), n_splits, cap)
    assert int(jn) == int(tn) <= cap
    _assert_same(jk, tk, "spanning tree keys")
    out = to_numpy(tk[:int(tn) + 1]).astype(np.uint64)
    assert np.isin(splits[:n_splits + 1].astype(np.uint64), out).all()  # every split is a node boundary
    d = np.diff(out)
    assert ((d & (d - np.uint64(1))) == 0).all() and (np.log2(d.astype(np.float64)) % 3 == 0).all()


# ---------------------------------------------------------------------------
# binary radix tree and continuum trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", DTYPES, ids=["u32", "u64"])
def test_binary_tree_matches_jax(dt):
    rng = np.random.RandomState(4)
    keys = np.unique(_random_keys(rng, dt, 80)[2:])
    n, cap = len(keys), 128
    padded = np.full(cap, np.iinfo(dt).max, dt)
    padded[:n] = keys
    jt = jbt.build_binary_tree(jnp.asarray(padded), jnp.int32(n))
    tt = tbt.build_binary_tree(from_numpy(padded), n)
    for f in ("left", "right", "prefix_length", "n_internal"):
        _assert_same(getattr(jt, f), getattr(tt, f), f)
    # every leaf once, every internal node but the root once, as children
    n_int = int(tt.n_internal)
    assert n_int == n - 1
    children = torch.cat([tt.left[:n_int], tt.right[:n_int]]).numpy()
    assert sorted((children[children >= n_int] - n_int).tolist()) == list(range(n))
    assert sorted(children[children < n_int].tolist()) == list(range(1, n_int))


def _blob_jnp(x, y, z):
    r2 = (x - 0.3) ** 2 + (y - 0.6) ** 2 + (z - 0.5) ** 2
    return 40000.0 / (1.0 + 60.0 * r2)


def _blob_torch(x, y, z):
    r2 = (x - 0.3) ** 2 + (y - 0.6) ** 2 + (z - 0.5) ** 2
    return 40000.0 / (1.0 + 60.0 * r2)


@pytest.mark.parametrize("dt, curve, uniform", [(np.uint32, jenc.HILBERT, True), (np.uint32, jenc.HILBERT, False),
                                                (np.uint32, jenc.MORTON, False), (np.uint64, jenc.HILBERT, False),
                                                (np.uint64, jenc.MORTON, False)],
                         ids=["u32-hilbert-uniform", "u32-hilbert", "u32-morton", "u64-hilbert", "u64-morton"])
def test_continuum_tree_matches_jax(dt, curve, uniform):
    # the concentration is one rational function written twice, so that both
    # sides evaluate it with the same correctly rounded operations
    if uniform:
        jconc, tconc = (lambda x, y, z: jnp.full_like(x, 32000.0)), (lambda x, y, z: torch.full_like(x, 32000.0))
    else:
        jconc, tconc = _blob_jnp, _blob_torch
    jt = jcont.compute_continuum_csarray(jconc, jbox.make_box(0.0, 1.0), 64, 4096, dt, curve=curve)
    tt = tcont.compute_continuum_csarray(tconc, tbox.make_box(0.0, 1.0, device="cpu"), 64, 4096, dt, curve=curve)
    n = int(tt.n_nodes)
    assert int(jt.n_nodes) == n > 8
    _assert_same(jt.keys, tt.keys, "keys")
    _assert_same(jt.counts, tt.counts, "counts, rounded")
    d = np.diff(to_numpy(tt.keys[:n + 1]).astype(np.uint64))
    assert ((d & (d - np.uint64(1))) == 0).all()
    if uniform:
        assert len(np.unique(d)) == 1 and int(tt.counts[:n].max()) <= 64 * 8


# ---------------------------------------------------------------------------
# sfc leftovers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", DTYPES, ids=["u32", "u64"])
def test_sfc_keys_leftovers_match_jax(dt):
    rng = np.random.RandomState(5)
    lmax = LMAX[dt]
    assert tkeys.max_coord(dt) == jkeys.max_coord(dt) == 1 << lmax
    x = np.concatenate([[0.0, 1.0, np.nextafter(np.float32(1), np.float32(0))],
                        rng.uniform(0, 1, 200)]).astype(np.float32)
    _assert_same(jkeys.to_nbit_int(jnp.asarray(x), dt), tkeys.to_nbit_int(torch.from_numpy(x), dt), "to_nbit_int")

    for length in (0, 3, 6, 12, 3 * lmax):
        prefix = (rng.randint(0, 2**62, size=50).astype(np.uint64) % (np.uint64(1) << np.uint64(length))).astype(dt)
        _assert_same(jkeys.pad_prefix(jnp.asarray(prefix), length), tkeys.pad_prefix(from_numpy(prefix), length),
                     f"pad_prefix {length}")
    lengths = rng.randint(1, 3 * lmax + 1, size=50)
    prefix = (rng.randint(0, 2**62, size=50).astype(np.uint64) % (np.uint64(1) << lengths.astype(np.uint64))).astype(dt)
    _assert_same(jkeys.pad_prefix(jnp.asarray(prefix), jnp.asarray(lengths, jnp.int32)),
                 tkeys.pad_prefix(from_numpy(prefix), torch.from_numpy(lengths)), "pad_prefix, array lengths")

    pow8 = np.array([8**i for i in range(lmax + 1)], np.uint64).astype(dt)
    vals = np.concatenate([pow8, pow8 + dt(1), np.array([0, 2, 4, 16, 63, 65], dt)])
    got = tkeys.is_power_of_8(from_numpy(vals))
    _assert_same(jkeys.is_power_of_8(jnp.asarray(vals)), got, "is_power_of_8")
    assert got[:lmax + 1].all() and not got[lmax + 1:].any()

    # nodes [k1, k2) at random levels
    level = rng.randint(0, lmax + 1, size=100)
    rng_ = (np.uint64(1) << (3 * (lmax - level)).astype(np.uint64)).astype(dt)
    k1 = (_random_keys(rng, dt, 100)[2:].astype(np.uint64) & ~(rng_[2:].astype(np.uint64) - np.uint64(1))).astype(dt)
    k2 = (k1 + rng_[2:]).astype(dt)
    _assert_same(jkeys.encode_placeholder_bit_2k(jnp.asarray(k1), jnp.asarray(k2)),
                 tkeys.encode_placeholder_bit_2k(from_numpy(k1), from_numpy(k2)), "encode_placeholder_bit_2k")

    keys = _random_keys(rng, dt, 100)
    masked = tkeys.mask_key(from_numpy(keys))
    _assert_same(jkeys.mask_key(jnp.asarray(keys)), masked, "mask_key")
    _assert_same(jkeys.unmask_key(jnp.asarray(to_numpy(masked))), tkeys.unmask_key(masked), "unmask_key")
    np.testing.assert_array_equal(to_numpy(tkeys.unmask_key(masked)), keys)
    for k in (keys, to_numpy(masked)):
        _assert_same(jkeys.is_masked(jnp.asarray(k)), tkeys.is_masked(from_numpy(k)), "is_masked")
    assert bool(tkeys.is_masked(masked)[2:].any()) and not bool(tkeys.is_masked(from_numpy(keys)).any())

    for n_bits in (0, 3, 7, 3 * lmax):
        _assert_same(jkeys.zero_low_bits(jnp.asarray(keys), n_bits), tkeys.zero_low_bits(from_numpy(keys), n_bits),
                     f"zero_low_bits {n_bits}")
    nb = rng.randint(0, 3 * lmax, size=keys.size)
    _assert_same(jkeys.zero_low_bits(jnp.asarray(keys), jnp.asarray(nb, jnp.int32)),
                 tkeys.zero_low_bits(from_numpy(keys), torch.from_numpy(nb)), "zero_low_bits, array widths")


@pytest.mark.parametrize("dt", DTYPES, ids=["u32", "u64"])
@pytest.mark.parametrize("curve", CURVES)
def test_sfc_encode_leftovers_match_jax(dt, curve):
    rng = np.random.RandomState(6)
    lmax = LMAX[dt]
    level = rng.randint(1, lmax + 1, size=60)
    rng_ = (np.uint64(1) << (3 * (lmax - level)).astype(np.uint64))
    k1 = (_random_keys(rng, dt, 60).astype(np.uint64) & ~(rng_ - np.uint64(1))).astype(dt)
    k1[1] = 0  # the random keys' end key is no node start
    k2 = (k1.astype(np.uint64) + rng_).astype(dt)
    jb = jenc.sfc_ibox_keys(jnp.asarray(k1), jnp.asarray(k2), curve)
    tb = tenc.sfc_ibox_keys(from_numpy(k1), from_numpy(k2), curve)
    _ibox_same(jb, tb, "sfc_ibox_keys")

    box_args = (-1.0, 1.0, 0.0, 2.0, -0.5, 0.5)
    jbx, tbx = jbox.make_box(*box_args), tbox.make_box(*box_args, device="cpu")
    center = np.stack([rng.uniform(-0.9, 0.9, 80), rng.uniform(0.1, 1.9, 80), rng.uniform(-0.4, 0.4, 80)], -1)
    size = rng.uniform(1e-4, 0.1, size=(80, 3))
    center, size = center.astype(np.float32), size.astype(np.float32)
    _assert_same(jenc.common_node_prefix(jnp.asarray(center), jnp.asarray(size), jbx, dt, curve),
                 tenc.common_node_prefix(torch.from_numpy(center), torch.from_numpy(size), tbx, dt, curve),
                 "common_node_prefix")

    for d in ((1, 0, 0), (-1, 0, 0), (0, 1, -1), (1, 1, 1), (-1, -1, 0)):
        for lv in (1, 3):
            _assert_same(jenc.sfc_neighbor(jb, lv, *d, dt, curve), tenc.sfc_neighbor(tb, lv, *d, dt, curve),
                         f"sfc_neighbor {d} level {lv}")


def test_sfc_box_leftovers_match_jax():
    rng = np.random.RandomState(7)
    args = (-1.0, 1.0, 0.0, 2.0, -0.5, 0.5)
    bnd = (jbox.PERIODIC, jbox.OPEN, jbox.PERIODIC)
    jbx, tbx = jbox.make_box(*args, boundaries=bnd), tbox.make_box(*args, boundaries=bnd, device="cpu")
    X = rng.uniform(-1.5, 2.5, size=(200, 3)).astype(np.float32)
    _assert_same(jbox.put_in_box(jnp.asarray(X), jbx), tbox.put_in_box(torch.from_numpy(X), tbx), "put_in_box")

    for dt in DTYPES:
        lmax = LMAX[dt]
        lo = rng.randint(0, (1 << lmax) - 8, size=(3, 50))
        span = rng.randint(1, 8, size=(3, 50))
        ib = [(lo[d], lo[d] + span[d]) for d in range(3)]
        jib = jbox.IBox(*(jnp.asarray(v, jnp.int32) for pair in ib for v in pair))
        tib = tbox.IBox(*(torch.from_numpy(v.astype(np.int64)) for pair in ib for v in pair))
        for jv, tv, f in zip(jbox.create_fp_box(jib, jbx, dt), tbox.create_fp_box(tib, tbx, dt), ("min", "max")):
            _assert_same(jv, tv, f"create_fp_box {f}")
        center = rng.uniform(-0.9, 0.9, size=(50, 3)).astype(np.float32)
        size = rng.uniform(1e-3, 0.05, size=(50, 3)).astype(np.float32)
        _ibox_same(jbox.create_ibox(jnp.asarray(center), jnp.asarray(size), jbx, dt),
                   tbox.create_ibox(torch.from_numpy(center), torch.from_numpy(size), tbx, dt), "create_ibox")

    fit, prev = (-0.9, 0.8, 0.3, 1.2, -0.6, 0.4), (-1.0, 1.0, 0.0, 2.0, -0.5, 0.5)
    jl = jbox.limit_box_shrinking(jbox.make_box(*fit), jbox.make_box(*prev, boundaries=bnd))
    tl = tbox.limit_box_shrinking(tbox.make_box(*fit, device="cpu"), tbox.make_box(*prev, boundaries=bnd, device="cpu"))
    _assert_same(jl.limits, tl.limits, "limit_box_shrinking")
    assert tl.boundaries == jl.boundaries == bnd


@pytest.mark.parametrize("dt", DTYPES, ids=["u32", "u64"])
def test_hilbert_2d_matches_jax(dt):
    rng = np.random.RandomState(6)
    bits = LMAX[dt]
    px = rng.randint(0, 1 << bits, 512).astype(np.uint32)
    py = rng.randint(0, 1 << bits, 512).astype(np.uint32)
    px[:2], py[:2] = [0, (1 << bits) - 1], [(1 << bits) - 1, 0]
    jk = jhil.ihilbert_2d(jnp.asarray(px), jnp.asarray(py), dt)
    tk = thil.ihilbert_2d(torch.from_numpy(px.astype(np.int64)), torch.from_numpy(py.astype(np.int64)), dt)
    _assert_same(jk, tk, "ihilbert_2d")
    jx, jy = jhil.decode_hilbert_2d(jk)
    tx, ty = thil.decode_hilbert_2d(tk)
    _assert_same(jx, tx, "decode x")
    _assert_same(jy, ty, "decode y")
    np.testing.assert_array_equal(tx.numpy(), px)
    np.testing.assert_array_equal(ty.numpy(), py)


# ---------------------------------------------------------------------------
# stencil_stats
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("level, curve", [(2, jenc.HILBERT), (3, jenc.MORTON), (4, jenc.HILBERT)])
def test_stencil_stats_match_jax(level, curve):
    rng = np.random.RandomState(8 + level)
    D = 1 << level
    occ = rng.poisson(3.0, size=D**3)
    occ[rng.uniform(size=occ.size) < 0.2] = 0
    offsets = np.concatenate([[0], np.cumsum(occ)]).astype(np.int64)
    perm, _ = tcell._rowmajor_cell_perm_np(level, curve)
    jperm, _ = jcell.rowmajor_cell_perm(level, curve)
    np.testing.assert_array_equal(np.asarray(jperm), perm)
    jp, jm = jcell.stencil_stats(jnp.asarray(offsets.astype(np.int32)), jperm, level)
    tp, tm = tcell.stencil_stats(torch.from_numpy(offsets), torch.from_numpy(perm.astype(np.int64)), level)
    assert tp.dtype == torch.float32 and float(tp) == float(jp) and int(tm) == int(jm)
    # the sum over cells of occ x the occupancy of its periodic 27-neighbourhood
    grid = occ[perm].reshape(D, D, D)
    nb = sum(np.roll(grid, (-dx, -dy, -dz), (0, 1, 2)) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1))
    assert float(tp) == float((grid * nb).sum()) and int(tm) == occ.max()


# ---------------------------------------------------------------------------
# exchange_focus (tests/test_exchange_focus.py at 8 ranks)
# ---------------------------------------------------------------------------

def test_exchange_focus_quantities_8ranks():
    R, cap = 8, 128
    end = np.uint64(1) << np.uint64(63)
    bounds = np.arange(R + 1, dtype=np.uint64) * (end // np.uint64(8))
    leaves = np.full(cap + 1, end, np.uint64)
    leaves[:65] = np.arange(65, dtype=np.uint64) * (end // np.uint64(64))  # the 64 level-2 cells
    li = np.arange(cap)
    owner = np.clip(li // 8, 0, R - 1)

    def values(rank):
        return np.where(owner == rank, 1000 * rank + li, -1).astype(np.int32)

    mesh = make_mesh(R)
    jassign = jdec.SfcAssignment(boundaries=jnp.asarray(bounds), counts=jnp.zeros((R,), jnp.int64))

    def jstep(v):
        rank = jax.lax.axis_index(rank_axis)
        out, matched = jax_exchange_focus(jnp.asarray(leaves), v, jassign, rank, rank_axis)
        return out, matched.astype(jnp.int32)

    fn = jax.jit(shard_map(jstep, mesh=mesh, in_specs=P(rank_axis), out_specs=(P(rank_axis), P(rank_axis)),
                           check_vma=False))
    vals = np.concatenate([values(r) for r in range(R)])
    jout, jmatched = fn(jax.device_put(jnp.asarray(vals), NamedSharding(mesh, P(rank_axis))))
    jout, jmatched = np.asarray(jout).reshape(R, cap), np.asarray(jmatched).reshape(R, cap)

    tassign = tdec.SfcAssignment(boundaries=from_numpy(bounds), counts=torch.zeros(R, dtype=torch.int64))

    def rank_fn(comm):
        return exchange_focus_quantities(from_numpy(leaves), torch.from_numpy(values(comm.rank)), tassign, comm.rank,
                                         comm)

    for r, (out, matched) in enumerate(run_ranks(R, rank_fn)):
        np.testing.assert_array_equal(out.numpy(), jout[r], err_msg=f"rank {r}")
        np.testing.assert_array_equal(matched.numpy().astype(np.int32), jmatched[r], err_msg=f"rank {r}")
        assert matched[:64].all() and (out[:64].numpy() == 1000 * (np.arange(64) // 8) + np.arange(64)).all()


# ---------------------------------------------------------------------------
# native/: the host C++ oracle against the port's own functions
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def host_lib():
    if not native.available():
        pytest.skip("the native host library did not build (g++ missing or failed)")
    return native


def test_native_hilbert_matches_port(host_lib):
    rng = np.random.RandomState(8)
    pos = rng.uniform(-1, 1, size=(5000, 3)).astype(np.float32)
    box = tbox.make_box(-1.0, 1.0, device="cpu")
    p = torch.from_numpy(pos)
    for dt in DTYPES:
        host = host_lib.hilbert_encode(pos[:, 0], pos[:, 1], pos[:, 2], box.limits.numpy(), dt)
        np.testing.assert_array_equal(host, to_numpy(tenc.compute_sfc_keys(p[:, 0], p[:, 1], p[:, 2], box, dt)))


def test_native_octree_matches_port(host_lib):
    rng = np.random.RandomState(9)
    for dt, n in ((np.uint64, 30000), (np.uint32, 8000)):
        keys = np.sort(_random_keys(rng, dt, n + 1)[:-1])
        host_tree, host_counts = host_lib.compute_octree_host(keys, 32)
        tree = tcs.compute_octree(from_numpy(keys), 32)
        nn = int(tree.n_nodes)
        np.testing.assert_array_equal(host_tree, to_numpy(tree.keys[:nn + 1]))
        np.testing.assert_array_equal(host_counts, tree.counts[:nn].numpy())
