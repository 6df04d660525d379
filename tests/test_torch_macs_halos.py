"""MAC marking and halo discovery of the PyTorch port against the JAX
package: batched_mark (breadth first here, depth first there),
geo_mac_spheres and the MAC radii, evaluate_mac and the mutual MACs,
mark_macs with limit_source both ways, make_halo_box, overlap_iboxes,
contained_in_keys, inside_box, and find_halos (periodic and open), which
is also held against an all-pairs oracle.

Tolerance: marks, flags and integer boxes exact; float centers and radii
bit-equal as well (the same operations in the same order). A MAC mark
could flip only where r2 and the squared radius differ in the last bit,
which needs one side to fuse a multiply-add the other does not; no input
here does."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cstone_tpu.focus.source_center import geo_mac_spheres as jax_geo_mac_spheres
from cstone_tpu.focus.source_center import set_mac_radii as jax_set_mac_radii
from cstone_tpu.sfc import PERIODIC
from cstone_tpu.sfc import make_box as jax_make_box
from cstone_tpu.sfc.box import IBox as JIBox
from cstone_tpu.traversal import boxoverlap as jbo
from cstone_tpu.traversal import macs as jmacs
from cstone_tpu.traversal.collisions import find_halos as jax_find_halos
from cstone_tpu.traversal.collisions import node_iboxes as jax_node_iboxes
from cstone_tpu.traversal.traversal import batched_mark as jax_batched_mark
from cstone_tpu_torch.focus.source_center import geo_mac_spheres, set_mac_radii
from cstone_tpu_torch.interop import from_numpy_tree
from cstone_tpu_torch.ops.keys64 import from_numpy
from cstone_tpu_torch.sfc import make_box
from cstone_tpu_torch.sfc.box import IBox
from cstone_tpu_torch.traversal import boxoverlap as tbo
from cstone_tpu_torch.traversal import macs as tmacs
from cstone_tpu_torch.traversal import traversal as ttrav
from cstone_tpu_torch.traversal.collisions import find_halos, node_iboxes
from tests.test_torch_octree_ops import _random_tree

import torch_threads  # noqa: F401  (two intra-op threads per xdist worker)

R21 = 1 << 21


def _boxes(periodic):
    b = PERIODIC if periodic else 0
    return jax_make_box(-1.0, 1.0, boundaries=b), make_box(-1.0, 1.0, boundaries=b, device="cpu")


def _tree(seed=3, dist="gauss", bucket=16):
    jl, t, _ = _random_tree(np.uint64, dist, bucket=bucket, seed=seed)
    return jl, from_numpy_tree(jl, device="cpu"), t


def _ibox_pair(rng, n, wrap):
    lo = rng.randint(-40 if wrap else 0, R21 - 64, (n, 3))
    ext = rng.randint(1, 1 << rng.randint(1, 20), (n, 3))
    hi = lo + ext if wrap else np.minimum(lo + ext, R21)
    f = [lo[:, 0], hi[:, 0], lo[:, 1], hi[:, 1], lo[:, 2], hi[:, 2]]
    return JIBox(*(jnp.asarray(a.astype(np.int32)) for a in f)), IBox(*(torch.from_numpy(a.astype(np.int64)) for a in f))


def test_overlap_and_inside_box_match_jax():
    rng = np.random.RandomState(0)
    ja, ta = _ibox_pair(rng, 600, True)
    jb, tb = _ibox_pair(rng, 600, True)
    np.testing.assert_array_equal(tbo.overlap_iboxes(ta, tb, np.uint64).numpy(),
                                  np.asarray(jbo.overlap_iboxes(ja, jb, np.uint64)))
    c = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    s = rng.uniform(0, 0.4, (300, 3)).astype(np.float32)
    jbox, tbox = _boxes(False)
    got = tbo.inside_box(torch.from_numpy(c), torch.from_numpy(s), tbox)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jbo.inside_box(jnp.asarray(c), jnp.asarray(s), jbox)))
    assert 0 < int(got.sum()) < 300


@pytest.mark.parametrize("curve", ["hilbert", "morton"])
def test_contained_in_keys_matches_jax(curve):
    rng = np.random.RandomState(1)
    jl, _, _ = _tree()
    leaves = np.asarray(jl.leaves)
    n = int(jl.n_leaf)
    # aligned node boxes (some inside a range), random boxes, wrapping boxes
    jnb = jax_node_iboxes(jl, curve)
    jr, tr = _ibox_pair(rng, 300, False)
    jw, tw = _ibox_pair(rng, 100, True)
    fields = ("xmin", "xmax", "ymin", "ymax", "zmin", "zmax")
    jall = JIBox(*(jnp.concatenate([getattr(jnb, f), getattr(jr, f), getattr(jw, f)]) for f in fields))
    tall = IBox(*(torch.from_numpy(np.asarray(getattr(jall, f)).astype(np.int64)) for f in fields))
    for lo, hi in ((leaves[0], leaves[n]), (leaves[n // 4], leaves[n // 2]), (leaves[n // 2], leaves[n])):
        want = np.asarray(jbo.contained_in_keys(jall, lo, hi, np.uint64, curve))
        got = tbo.contained_in_keys(tall, from_numpy(np.array(lo)), from_numpy(np.array(hi)), np.uint64, curve)
        np.testing.assert_array_equal(got.numpy(), want)
        # the whole key range holds every box, the wrapping ones too
        assert 0 < want.sum() and (want.all() == (lo == leaves[0] and hi == leaves[n]))


@pytest.mark.parametrize("periodic", [True, False])
def test_make_halo_box_matches_jax(periodic):
    rng = np.random.RandomState(2)
    jbox, tbox = _boxes(periodic)
    jb, tb = _ibox_pair(rng, 500, False)
    radius = np.concatenate([rng.uniform(0, 0.3, 490), [0.0, 2.0, 1e-7, 0.5, 1.0, 3.0, 0.1, 0.2, 0.25, 1e-3]]).astype(np.float32)
    jh = jbo.make_halo_box(jb, jnp.asarray(radius), jbox, np.uint64)
    th = tbo.make_halo_box(tb, torch.from_numpy(radius), tbox, np.uint64)
    for f in ("xmin", "xmax", "ymin", "ymax", "zmin", "zmax"):
        np.testing.assert_array_equal(getattr(th, f).numpy(), np.asarray(getattr(jh, f)), err_msg=f)


@pytest.mark.parametrize("periodic", [True, False])
def test_mac_radii_and_evaluation_match_jax(periodic):
    jl, tl, _ = _tree(seed=4)
    jbox, tbox = _boxes(periodic)
    inv = jmacs.inv_theta_min_mac(0.6)
    assert tmacs.inv_theta_min_mac(0.6) == inv and tmacs.inv_theta_vec_mac(0.6) == jmacs.inv_theta_vec_mac(0.6)
    jgeo = jax_geo_mac_spheres(jl, inv, jbox)
    tgeo = geo_mac_spheres(tl, inv, tbox)
    np.testing.assert_array_equal(tgeo.numpy(), np.asarray(jgeo))
    np.testing.assert_array_equal(tmacs.compute_min_mac_r2(tl, inv, tbox).numpy(),
                                  np.asarray(jmacs.compute_min_mac_r2(jl, inv, jbox)))

    rng = np.random.RandomState(5)
    n = np.asarray(jgeo).shape[0]
    exp = (np.asarray(jgeo)[:, :3] + rng.uniform(-0.05, 0.05, (n, 3))).astype(np.float32)
    mass = np.where(rng.rand(n) < 0.2, 0.0, 1.5).astype(np.float32)
    c4 = np.concatenate([exp, mass[:, None]], axis=1)
    np.testing.assert_allclose(
        tmacs.compute_vec_mac_r2(tl, torch.from_numpy(exp), 1.0 / 0.6, tbox).numpy(),
        np.asarray(jmacs.compute_vec_mac_r2(jl, jnp.asarray(exp), 1.0 / 0.6, jbox)), rtol=1e-6)
    np.testing.assert_allclose(set_mac_radii(tl, torch.from_numpy(c4), 1.0 / 0.6, tbox).numpy(),
                               np.asarray(jax_set_mac_radii(jl, jnp.asarray(c4), 1.0 / 0.6, jbox)), rtol=1e-6)

    # point-box and box-box acceptance on random pairs
    m = 2000
    ca, cb = (rng.uniform(-1, 1, (m, 3)).astype(np.float32) for _ in range(2))
    sa, sb = (rng.uniform(0.01, 0.2, (m, 3)).astype(np.float32) for _ in range(2))
    mac_sq = (rng.uniform(0, 0.5, m).astype(np.float32) * np.where(rng.rand(m) < 0.3, -1, 1)).astype(np.float32)
    T, J = torch.from_numpy, jnp.asarray
    for jb_, tb_ in ((jbox, tbox), (None, None)):
        np.testing.assert_array_equal(
            tmacs.evaluate_mac(T(ca), T(mac_sq), T(cb), T(sb), tb_).numpy(),
            np.asarray(jmacs.evaluate_mac(J(ca), J(mac_sq), J(cb), J(sb), jb_)))
        np.testing.assert_array_equal(
            tbo.min_distance_point_box(T(ca), T(cb), T(sb), tb_).numpy(),
            np.asarray(jbo.min_distance_point_box(J(ca), J(cb), J(sb), jb_)))
    np.testing.assert_array_equal(
        tmacs.min_mac_mutual(T(ca), T(sa), T(cb), T(sb), tbox, inv).numpy(),
        np.asarray(jmacs.min_mac_mutual(J(ca), J(sa), J(cb), J(sb), jbox, inv)))
    np.testing.assert_array_equal(
        tmacs.min_vec_mac_mutual(T(ca), T(sa), T(cb), T(sb), tbox, inv).numpy(),
        np.asarray(jmacs.min_vec_mac_mutual(J(ca), J(sa), J(cb), J(sb), jbox, inv)))


@pytest.mark.parametrize("endpoints_only", [True, False])
def test_batched_mark_matches_jax(endpoints_only):
    jl, tl, _ = _tree(seed=6)
    jbox, tbox = _boxes(True)
    jgeo = jax_geo_mac_spheres(jl, 1.0, jbox)
    tgeo = torch.from_numpy(np.array(jgeo))
    rng = np.random.RandomState(7)
    nq = 41
    qc = rng.uniform(-1, 1, (nq, 3)).astype(np.float32)
    active = rng.rand(nq) < 0.8
    r2 = np.float32(0.15 ** 2)

    def jcrit(q, nid):
        d = jnp.abs(jgeo[nid, :3] - jnp.asarray(qc)[q]) - jnp.sqrt(jgeo[nid, 3:4]) / 2
        return jnp.sum(jnp.maximum(d, 0) ** 2, axis=-1) < r2

    def tcrit(q, nid):
        d = torch.abs(tgeo[nid, :3] - torch.from_numpy(qc)[q]) - torch.sqrt(tgeo[nid, 3:4]) / 2
        d = torch.clamp(d, min=0)
        return d[:, 0] ** 2 + d[:, 1] ** 2 + d[:, 2] ** 2 < r2

    want = np.asarray(jax_batched_mark(jl.child_offsets, jcrit, nq, endpoints_only, active_mask=jnp.asarray(active)))
    log = ttrav.mark_levels_log = []
    try:
        for chunk in (ttrav.MARK_CHUNK, 64):  # the second splits every level into many criterion calls
            old, ttrav.MARK_CHUNK = ttrav.MARK_CHUNK, chunk
            got = ttrav.batched_mark(tl.child_offsets, tcrit, nq, endpoints_only, active_mask=torch.from_numpy(active))
            ttrav.MARK_CHUNK = old
            np.testing.assert_array_equal(got.numpy(), want)
    finally:
        ttrav.mark_levels_log = None
    assert 0 < want.sum() < int(jl.n_nodes)
    # one iteration per tree level below the root, not one per visited node
    depth = int((np.diff(np.asarray(jl.level_range)) > 0).sum()) - 1
    assert log == [depth, depth]
    # no active query: nothing is marked, the root included
    none = ttrav.batched_mark(tl.child_offsets, tcrit, nq, endpoints_only, active_mask=torch.zeros(nq, dtype=torch.bool))
    assert int(none.sum()) == 0


@pytest.mark.parametrize("limit_source", [True, False])
@pytest.mark.parametrize("periodic", [True, False])
def test_mark_macs_matches_jax(periodic, limit_source):
    jl, tl, _ = _tree(seed=8, bucket=8)
    jbox, tbox = _boxes(periodic)
    inv = jmacs.inv_theta_min_mac(1.0)
    jc = jax_geo_mac_spheres(jl, inv, jbox)
    tc = geo_mac_spheres(tl, inv, tbox)
    leaves = np.asarray(jl.leaves)
    n = int(jl.n_leaf)
    for a, b in ((n // 3, n // 2), (0, n // 6), (0, n)):
        fs, fe = leaves[a], leaves[b]
        want = np.asarray(jmacs.mark_macs(jl, jc, jbox, fs, fe, jl.leaves, jl.n_leaf, limit_source))
        got = tmacs.mark_macs(tl, tc, tbox, from_numpy(np.array(fs)), from_numpy(np.array(fe)), tl.leaves,
                              tl.n_leaf, limit_source)
        np.testing.assert_array_equal(got.numpy(), want)
        assert (want.sum() == 0) == (b - a == n)  # the whole domain in focus: nothing outside to mark


def _halo_oracle(jl, radii, jbox, first, last):
    """All pairs: every leaf outside [first, last) whose box overlaps the
    halo box of a leaf inside it (the oracle of tests/test_collisions.py)."""
    from cstone_tpu.sfc.encode import sfc_ibox
    from cstone_tpu.sfc.keys import tree_level

    leaves = jl.leaves
    n = int(jl.n_leaf)
    key = leaves[:-1]
    level = tree_level(jnp.where(leaves[1:] > key, leaves[1:] - key, jnp.uint64(1)))
    ib = sfc_ibox(key, level)
    hb = jbo.make_halo_box(ib, jnp.asarray(radii), jbox, np.uint64)
    flags = np.zeros(len(radii), np.int32)
    for i in range(first, last):
        one = JIBox(*(getattr(hb, f)[i] for f in ("xmin", "xmax", "ymin", "ymax", "zmin", "zmax")))
        hit = np.asarray(jbo.overlap_iboxes(ib, one, np.uint64))[:n]
        flags[:n] |= hit
    flags[first:last] = 0
    return flags


@pytest.mark.parametrize("periodic", [True, False])
def test_find_halos_matches_jax_and_oracle(periodic):
    jl, tl, t = _tree(seed=9, dist="uniform", bucket=32)
    jbox, tbox = _boxes(periodic)
    n = int(jl.n_leaf)
    cap = len(np.asarray(t.counts))
    rng = np.random.RandomState(10)
    for first, last in ((n // 4, n // 2), (0, n // 8), (n - n // 8, n)):
        radii = np.zeros(cap, np.float32)
        radii[first:last] = rng.uniform(0.02, 0.12, last - first)
        want = np.asarray(jax_find_halos(jl, jnp.asarray(radii), jbox, first, last))
        got = find_halos(tl, torch.from_numpy(radii), tbox, first, last)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy(), _halo_oracle(jl, radii, jbox, first, last))
        assert 0 < want.sum() < n and want[first:last].sum() == 0
        # precomputed node boxes give the same flags
        again = find_halos(tl, torch.from_numpy(radii), tbox, torch.tensor(first), torch.tensor(last),
                           node_boxes=node_iboxes(tl))
        np.testing.assert_array_equal(again.numpy(), want)
