"""The grid cover of the PyTorch port (traversal/cover.py) against the
JAX package (cstone_tpu/traversal/cover.py) on test_cover.py's inputs,
over uint32/uint64 keys, Hilbert/Morton curves and periodic/open boxes,
and the cover route's counts through B5's plain version against brute
force; and the leaves the cover and the clients stand on (bit_width,
isfc_key_top, leaf_geometry, leaf_layout_from_counts) against JAX's.

Tolerance: none. Tables, runs, run counts, overflow flags, keys, bit
widths, leaf geometry and layouts are bit-equal to JAX; the counts equal
the O(n^2) oracle."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cstone_tpu.sfc import PERIODIC, compute_sfc_keys, make_box as jax_make_box
from cstone_tpu.traversal.cover import build_cell_table as jax_table
from cstone_tpu.traversal.cover import group_cover_runs as jax_cover
from cstone_tpu_torch.ops.keys64 import from_numpy as keys_from_numpy
from cstone_tpu_torch.ops.neighbors_v2 import pairwise_count_runs
from cstone_tpu_torch.sfc import make_box
from cstone_tpu_torch.traversal.cover import build_cell_table, group_cover_runs

import torch_threads  # noqa: F401  (two intra-op threads per xdist worker)

RUN_CAP = 96


def _setup(seed, n, hmin, hmax, periodic, key_dtype, curve, cluster=True):
    """test_cover.py's _setup with a key type and curve of choice; also the
    groups' boxes and radii (group size G = 32)."""
    rng = np.random.RandomState(seed)
    pos = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    if cluster:
        nc = n // 4
        pos[:nc] = 0.5 + 0.02 * rng.randn(nc, 3).astype(np.float32)
        pos = np.clip(pos, 0, 0.999999)
    h = rng.uniform(hmin, hmax, n).astype(np.float32)
    box = jax_make_box(0.0, 1.0, boundaries=PERIODIC if periodic else 0)
    keys = np.asarray(compute_sfc_keys(*(jnp.asarray(pos[:, i]) for i in range(3)), box, key_dtype, curve))
    order = np.argsort(keys, kind="stable")
    return pos[order], h[order], keys[order], box


def _groups(pos, h, G):
    n = pos.shape[0]
    n_groups = -(-n // G)
    pad = n_groups * G - n
    P3 = np.concatenate([pos, np.zeros((pad, 3), np.float32)]).reshape(n_groups, G, 3)
    gvalid = (np.arange(n_groups * G) < n).reshape(n_groups, G)
    big = np.float32(1e30)
    gmin = np.where(gvalid[..., None], P3, big).min(1)
    gmax = np.where(gvalid[..., None], P3, -big).max(1)
    gh = np.concatenate([h, np.zeros(pad, np.float32)]).reshape(n_groups, G)
    grad = (np.float32(2.0) * np.where(gvalid, gh, 0).max(1)).astype(np.float32)
    return P3, gvalid, gh, gmin, gmax, grad


def _brute(pos, h, periodic):
    X = pos.astype(np.float64)
    d = X[:, None, :] - X[None, :, :]
    if periodic:
        d -= np.rint(d)
    d2 = (d * d).sum(-1)
    np.fill_diagonal(d2, np.inf)
    return (d2 < (2.0 * h.astype(np.float64)[:, None]) ** 2).sum(1)


def _both(pos, h, keys, box, periodic, key_dtype, curve, Lt, G=32, run_cap=RUN_CAP, active=None, C=8):
    _, _, _, gmin, gmax, grad = _groups(pos, h, G)
    jt = jax_table(jnp.asarray(keys), Lt)
    jout = jax_cover(jnp.asarray(gmin), jnp.asarray(gmax), jnp.asarray(grad), jt, Lt, box, key_dtype, curve,
                     cells_per_dim=C, run_cap=run_cap,
                     active=None if active is None else jnp.asarray(active))
    tt = build_cell_table(keys_from_numpy(keys, "cpu"), Lt)
    tbox = make_box(0.0, 1.0, boundaries=PERIODIC if periodic else 0, device="cpu")
    tout = group_cover_runs(torch.from_numpy(gmin), torch.from_numpy(gmax), torch.from_numpy(grad), tt, Lt,
                            tbox, key_dtype, curve, cells_per_dim=C, run_cap=run_cap,
                            active=None if active is None else torch.from_numpy(active))
    return (jt, jout), (tt, tout), tbox


@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("curve", ["hilbert", "morton"])
@pytest.mark.parametrize("key_dtype", [np.uint32, np.uint64])
def test_cover_matches_jax_and_counts_match_brute_force(key_dtype, curve, periodic):
    pos, h, keys, box = _setup(1, 1500, 0.02, 0.09, periodic, key_dtype, curve)
    (jt, jout), (tt, tout), tbox = _both(pos, h, keys, box, periodic, key_dtype, curve, Lt=6)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    for t, j in zip(tout, jout):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert not bool(tout[3])

    # the cover's runs through B5's plain version (CPU tensors): exact
    P3, gvalid, gh, *_ = _groups(pos, h, 32)
    targets = torch.from_numpy(P3)
    r2 = torch.from_numpy(np.where(gvalid, (2.0 * gh) * (2.0 * gh), -1.0).astype(np.float32))
    xs, ys, zs = (torch.from_numpy(np.ascontiguousarray(pos[:, i])) for i in range(3))
    box_params = torch.cat([tbox.lengths, 1.0 / tbox.lengths,
                            torch.as_tensor(tbox.periodic_mask, dtype=torch.float32)])
    counts = pairwise_count_runs(targets, r2, tout[0], tout[1], xs, ys, zs, box_params)
    np.testing.assert_array_equal(counts.reshape(-1)[:pos.shape[0]].numpy(), _brute(pos, h, periodic))


@pytest.mark.parametrize("Lt", [5, 7])
def test_cover_table_levels_match_jax(Lt):
    pos, h, keys, box = _setup(4, 800, 0.03, 0.12, True, np.uint64, "hilbert")
    (jt, jout), (tt, tout), _ = _both(pos, h, keys, box, True, np.uint64, "hilbert", Lt, G=16)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    for t, j in zip(tout, jout):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_cover_inactive_groups_and_run_overflow_match_jax():
    pos, h, keys, box = _setup(2, 1200, 0.02, 0.09, True, np.uint64, "hilbert")
    n_groups = -(-1200 // 32)
    active = np.arange(n_groups) % 3 != 0
    (_, jout), (_, tout), _ = _both(pos, h, keys, box, True, np.uint64, "hilbert", 6, run_cap=4,
                                    active=active, C=4)
    for t, j in zip(tout, jout):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert bool(tout[3]) and int(tout[2][~torch.from_numpy(active)].max()) == 0


def test_cell_table_n_valid_matches_jax():
    _, _, keys, _ = _setup(3, 900, 0.02, 0.05, False, np.uint64, "hilbert", cluster=False)
    for n_valid in (0, 517, 900):
        np.testing.assert_array_equal(
            build_cell_table(keys_from_numpy(keys, "cpu"), 4, n_valid=n_valid).numpy(),
            np.asarray(jax_table(jnp.asarray(keys), 4, n_valid=n_valid)))


# the leaves the cover and the clients stand on: bit_width, isfc_key_top
# (ihilbert_top), leaf_geometry, leaf_layout_from_counts


@pytest.mark.parametrize("dtype", [np.uint32, np.uint64])
def test_bit_width_matches_jax(dtype):
    from cstone_tpu.ops.bits import bit_width as jax_bit_width
    from cstone_tpu_torch.ops.bits import bit_width

    rng = np.random.RandomState(1)
    bits = 32 if dtype == np.uint32 else 64
    special = np.array([0, 1, 2, 3, 255, 256, (1 << (bits - 1)) - 1, 1 << (bits - 1), (1 << bits) - 1], dtype)
    wide = rng.randint(0, 1 << 30, 50).astype(np.uint64) << np.uint64(bits - 31)
    v = np.concatenate([special, rng.randint(0, 1 << 31, 200).astype(dtype), wide.astype(dtype)])
    np.testing.assert_array_equal(bit_width(keys_from_numpy(v, "cpu")).numpy(), np.asarray(jax_bit_width(jnp.asarray(v))))


@pytest.mark.parametrize("curve", ["hilbert", "morton"])
@pytest.mark.parametrize("lmax,levels", [(21, 1), (21, 6), (21, 10), (10, 4), (10, 10)])
def test_isfc_key_top_matches_jax(curve, lmax, levels):
    from cstone_tpu.sfc.encode import isfc_key_top as jax_key_top
    from cstone_tpu_torch.ops.keys64 import srl
    from cstone_tpu_torch.sfc.encode import isfc_key, isfc_key_top

    rng = np.random.RandomState(levels)
    ijk = [rng.randint(0, 1 << lmax, 500).astype(np.uint32) for _ in range(3)]
    got = isfc_key_top(*(torch.from_numpy(a.astype(np.int64)) for a in ijk), levels, lmax, curve)
    want = np.asarray(jax_key_top(*(jnp.asarray(a) for a in ijk), levels, lmax, curve))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    # the top bits of the full key
    dt = np.uint64 if lmax == 21 else np.uint32
    full = isfc_key(*(torch.from_numpy(a.astype(np.int64)) for a in ijk), dt, curve)
    np.testing.assert_array_equal(got.numpy(), srl(full, 3 * (lmax - levels)).numpy().astype(np.int64))


@pytest.mark.parametrize("periodic", [True, False])
def test_leaf_geometry_and_layout_match_jax(periodic):
    from cstone_tpu.domain.layout import leaf_layout_from_counts as jax_layout
    from cstone_tpu.traversal.geometry import leaf_geometry as jax_leaf_geometry
    from cstone_tpu.tree import compute_octree
    from cstone_tpu_torch.domain.layout import leaf_layout_from_counts
    from cstone_tpu_torch.traversal.geometry import leaf_geometry

    pos, h, keys, box = _setup(6, 1500, 0.02, 0.05, periodic, np.uint64, "hilbert")
    tree = compute_octree(jnp.asarray(keys), bucket_size=16, capacity=1024)
    tbox = make_box(0.0, 1.0, boundaries=PERIODIC if periodic else 0, device="cpu")
    jc, js = jax_leaf_geometry(tree.keys, tree.n_nodes, box)
    tc, ts = leaf_geometry(keys_from_numpy(np.asarray(tree.keys), "cpu"), int(tree.n_nodes), tbox)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    counts = np.asarray(tree.counts)
    np.testing.assert_array_equal(leaf_layout_from_counts(torch.from_numpy(counts.astype(np.int64))).numpy(),
                                  np.asarray(jax_layout(tree.counts)))
