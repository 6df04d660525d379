"""Cell-list neighbor counts and SPH density of the PyTorch port against
the JAX package.

Tolerances: the ELL pack and the counts are bit-equal to the JAX roll
stencil (impl="xla"), by every port route (impl="pallas", "pallas_asym",
"xla"); against the JAX symmetric Pallas kernel (interpret
mode) counts may differ by the pinned 1-count threshold flip of
test_celllist.py::test_sym_kernel_threshold_pair_flip_is_bounded; density
within rtol 2e-4, the tolerance of test_sph_celllist.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cstone_tpu.sfc import PERIODIC
from cstone_tpu.sfc import compute_sfc_keys as jax_compute_sfc_keys
from cstone_tpu.sfc import make_box as jax_make_box
from cstone_tpu.traversal import celllist as jcl
from cstone_tpu_torch.ops import stencil
from cstone_tpu_torch.ops.keys64 import from_numpy
from cstone_tpu_torch.ops.stencil import (
    stencil_counts,
    stencil_counts_asym,
    stencil_cross,
    stencil_cross_plain,
    stencil_density,
)
from cstone_tpu_torch.sfc import make_box
from cstone_tpu_torch.traversal import celllist as tcl

import torch_threads  # noqa: F401  (two intra-op threads per xdist worker)

MASS = 0.37


def _setup(n, periodic, seed, gauss=False, hval=None):
    """Key-sorted particles in [-1, 1]^3, the same arrays for both packages."""
    rng = np.random.RandomState(seed)
    if gauss:
        pos = np.clip(rng.normal(0, 0.25, size=(n, 3)), -0.99, 0.99).astype(np.float32)
    else:
        pos = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    h = (np.full(n, hval) if hval else rng.uniform(0.04, 0.12, size=n)).astype(np.float32)
    b = PERIODIC if periodic else 0
    jbox, tbox = jax_make_box(-1.0, 1.0, boundaries=b), make_box(-1.0, 1.0, boundaries=b, device="cpu")
    keys = np.asarray(jax_compute_sfc_keys(*(jnp.asarray(pos[:, i]) for i in range(3)), jbox, jnp.uint64))
    order = np.argsort(keys, kind="stable")
    x, y, z, h, keys = pos[order, 0], pos[order, 1], pos[order, 2], h[order], keys[order]
    return (x, y, z, h, keys), jbox, tbox


def _jax(arrs):
    x, y, z, h, keys = arrs
    return (jnp.asarray(keys),) + tuple(jnp.asarray(a) for a in (x, y, z, h))


def _port(arrs):
    x, y, z, h, keys = arrs
    return (from_numpy(keys),) + tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in (x, y, z, h))


def _cap(keys, level, multiple):
    occ = np.bincount((keys >> np.uint64(3 * (21 - level))).astype(np.int64))
    return max(multiple, -(-int(occ.max()) // multiple) * multiple)


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("gauss", [False, True])
def test_counts_match_jax_xla(periodic, gauss):
    arrs, jbox, tbox = _setup(2000, periodic, seed=21, gauss=gauss)
    level = tcl.choose_cell_level(tbox, float(arrs[3].max()))
    assert level == jcl.choose_cell_level(jbox, float(arrs[3].max()))
    cap = _cap(arrs[4], level, 8)
    jc, jovf = jcl.cell_list_neighbor_counts(*_jax(arrs), jbox, level, cap, impl="xla")
    assert not bool(jovf)
    # every port route: the kernel (B1), the one-sided route (B4, self pair
    # counted then subtracted) and the plain roll stencil
    for impl in ("pallas", "pallas_asym", "xla"):
        tc, tovf = tcl.cell_list_neighbor_counts(*_port(arrs), tbox, level, cap, impl=impl)
        assert not bool(tovf)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc), err_msg=impl)


@pytest.mark.parametrize("periodic", [False, True])
def test_counts_vs_jax_pallas_within_flip_bound(periodic):
    arrs, jbox, tbox = _setup(1500, periodic, seed=77)
    level, cap = 2, 64
    cap = max(cap, _cap(arrs[4], level, 64))
    jc, _ = jcl.cell_list_neighbor_counts(*_jax(arrs), jbox, level, cap, impl="pallas", interpret=True)
    tc, tovf = tcl.cell_list_neighbor_counts(*_port(arrs), tbox, level, cap)
    assert not bool(tovf)
    assert np.abs(tc.numpy().astype(np.int64) - np.asarray(jc).astype(np.int64)).max() <= 1


@pytest.mark.parametrize("n_valid", [None, 1700])
def test_pack_and_plain_stencil_match_jax(n_valid):
    arrs, jbox, tbox = _setup(2000, True, seed=5, gauss=True)
    x, y, z, h, keys = arrs
    level = 3
    cap = _cap(keys, level, 8)
    jperm, _ = jcl.rowmajor_cell_perm(level)
    tperm, _ = tcl.rowmajor_cell_perm(level, device="cpu")
    np.testing.assert_array_equal(tperm.numpy(), np.asarray(jperm))
    jpacked, jvalid, jpidx, jovf = jcl.ell_pack_gather(
        jnp.asarray(keys), jperm, tuple(jnp.asarray(a) for a in (x, y, z, h)), cap, level,
        n_valid=n_valid)
    k, *cols = _port(arrs)
    tpacked, tvalid, tpidx, tovf = tcl.ell_pack_gather(k, tperm, tuple(cols), cap, level, n_valid=n_valid)
    assert bool(jovf) == bool(tovf) is False
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    np.testing.assert_array_equal(tpidx.numpy(), np.asarray(jpidx))
    for a, b in zip(jpacked, tpacked):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    jr2 = jnp.where(jvalid, (2.0 * jpacked[3]) ** 2, -1.0)
    tr2 = torch.where(tvalid, (2.0 * tpacked[3]) * (2.0 * tpacked[3]), -1.0)
    jc = jcl.stencil_neighbor_counts(*jpacked[:3], jr2, jvalid, jbox, level)
    tc = tcl.stencil_neighbor_counts(*tpacked[:3], tr2, tvalid, tbox, level)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_overflow_flag():
    arrs, jbox, tbox = _setup(500, False, seed=3)
    level = tcl.choose_cell_level(tbox, float(arrs[3].max()))
    _, ovf = tcl.cell_list_neighbor_counts(*_port(arrs), tbox, level, cap=2)
    assert bool(ovf)


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("per_particle_mass", [False, True])
def test_density_matches_jax(periodic, per_particle_mass):
    arrs, jbox, tbox = _setup(1200, periodic, seed=31)
    level = tcl.choose_cell_level(tbox, float(arrs[3].max()))
    cap = _cap(arrs[4], level, 64)
    m = np.random.RandomState(5).uniform(0.2, 1.7, size=1200).astype(np.float32)
    jm = jnp.asarray(m) if per_particle_mass else MASS
    tm = torch.from_numpy(m) if per_particle_mass else MASS
    jr, _ = jcl.cell_list_sph_density(*_jax(arrs), jbox, level, cap, mass=jm, interpret=True)
    tr, tovf = tcl.cell_list_sph_density(*_port(arrs), tbox, level, cap, mass=tm)
    assert not bool(tovf)
    jr = np.asarray(jr)
    np.testing.assert_allclose(tr.numpy(), jr, rtol=2e-4, atol=1e-6 * jr.max())


@pytest.mark.parametrize("periodic", [False, True])
def test_kernel_wrappers_take_plain_path_on_cpu(periodic):
    # CPU tensors go to the plain version: wrapper counts equal the JAX
    # roll stencil, and the density wrapper's self-excluded sum of a lone
    # valid pair is one spline weight per side
    arrs, jbox, tbox = _setup(800, periodic, seed=13, hval=0.09)
    level = 3
    cap = _cap(arrs[4], level, 8)
    k, *cols = _port(arrs)
    perm, _ = tcl.rowmajor_cell_perm(level, device="cpu")
    (px, py, pz, ph), valid, _, _ = tcl.ell_pack_gather(k, perm, tuple(cols), cap, level)
    r2 = torch.where(valid, (2.0 * ph) * (2.0 * ph), -1.0)
    flags = (periodic,) * 3
    plain = tcl.stencil_neighbor_counts(px, py, pz, r2, valid, tbox, level)
    np.testing.assert_array_equal(stencil_counts(px, py, pz, r2, valid, tbox.lengths, flags, level).numpy(),
                                  plain.numpy())
    dens = stencil_density(px, py, pz, ph, valid, tbox.lengths, flags, level)
    assert torch.isfinite(dens).all() and (dens[~valid] == 0).all()
    with pytest.raises(ValueError, match="level >= 2"):
        stencil_counts(px[:8], py[:8], pz[:8], r2[:8], valid[:8], tbox.lengths, flags, 1)


def test_unknown_impl_raises():
    arrs, _, tbox = _setup(300, True, seed=8)
    with pytest.raises(ValueError, match="impl must be one of"):
        tcl.cell_list_neighbor_counts(*_port(arrs), tbox, 2, 64, impl="nope")


def test_asym_wrapper_subtracts_only_counted_self_pairs():
    # a valid target with r2 <= 0 never counted itself, so nothing is subtracted
    arrs, jbox, tbox = _setup(600, True, seed=4, hval=0.1)
    level = 3
    k, *cols = _port(arrs)
    perm, _ = tcl.rowmajor_cell_perm(level, device="cpu")
    (px, py, pz, ph), valid, _, _ = tcl.ell_pack_gather(k, perm, tuple(cols), _cap(arrs[4], level, 8), level)
    r2 = torch.where(valid, (2.0 * ph) * (2.0 * ph), -1.0)
    r2[valid.nonzero()[:5].unbind(1)] = 0.0
    flags = (True,) * 3
    args = (px, py, pz, r2, valid, tbox.lengths, flags, level)
    np.testing.assert_array_equal(stencil_counts_asym(*args).numpy(), stencil_counts(*args).numpy())


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("op", ["count", "density"])
def test_cross_plain_matches_jax_cross_kernel(periodic, op):
    # the cross pass (B3) between two disjoint halves of a sample with
    # unequal caps, against the JAX Pallas cross kernel in interpret mode:
    # counts exact, density within rtol 2e-4 (test_sph_celllist.py)
    from cstone_tpu.ops.pallas_stencil import stencil_counts_pallas_cross

    arrs, jbox, tbox = _setup(1200, periodic, seed=19)
    x, y, z, h, keys = arrs
    level = 2
    in_b = np.random.RandomState(3).uniform(size=x.shape[0]) < 0.3
    ells = []
    for sel in (~in_b, in_b):
        sub = tuple(a[sel] for a in arrs)
        cap = _cap(sub[4], level, 64) + 64 * int(not sel[0] == in_b[0])
        k, *cols = _port(sub)
        perm, _ = tcl.rowmajor_cell_perm(level, device="cpu")
        (px, py, pz, ph), valid, _, _ = tcl.ell_pack_gather(k, perm, tuple(cols), cap, level)
        w = torch.where(valid, (2.0 * ph) * (2.0 * ph), -1.0) if op == "count" else ph
        ells.append((px, py, pz, w, valid))
    assert ells[0][0].shape[1] != ells[1][0].shape[1], "caps must differ"
    flags = (periodic,) * 3
    ta, tb = stencil_cross(ells[0], ells[1], tbox.lengths, flags, level, op=op)
    pa, pb = stencil_cross_plain(ells[0], ells[1], tbox.lengths, flags, level, op=op)
    np.testing.assert_array_equal(ta.numpy(), pa.numpy())
    np.testing.assert_array_equal(tb.numpy(), pb.numpy())
    j = [tuple(jnp.asarray(t.numpy()) for t in e) for e in ells]
    ja, jb = stencil_counts_pallas_cross(j[0][:4], j[1][:4], j[1][4], jbox.lengths, flags, level,
                                         op=op, interpret=True)
    if op == "count":
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    else:
        for got, want, valid in ((ta, ja, ells[0][4]), (tb, jb, ells[1][4])):
            want = np.where(valid.numpy(), np.asarray(want), 0.0)
            np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=1e-6 * want.max())


@pytest.mark.parametrize("op", ["count", "density"])
def test_plain_stencil_cell_runs_give_the_same_result(op):
    # the plain version builds its pair tensors for runs of cells; one cell
    # per run gives what the whole grid at once gives
    arrs, _, tbox = _setup(1500, True, seed=23, gauss=True)
    level = 3
    k, *cols = _port(arrs)
    m = torch.from_numpy(np.random.RandomState(2).uniform(0.5, 1.5, 1500).astype(np.float32))
    perm, _ = tcl.rowmajor_cell_perm(level, device="cpu")
    (px, py, pz, ph, pm), valid, _, _ = tcl.ell_pack_gather(k, perm, tuple(cols) + (m,),
                                                     _cap(arrs[4], level, 8), level)
    density = op == "density"
    w = ph if density else torch.where(valid, (2.0 * ph) * (2.0 * ph), -1.0)
    args = ((px, py, pz, w, valid), (px, py, pz, pm if density else None, valid),
            tbox.lengths, (True,) * 3, level, True)
    whole = stencil._stencil_plain(density, *args)
    runs = stencil._stencil_plain(density, *args, max_pairs=1)
    assert int(valid.sum()) == 1500 and bool((whole[valid] > 0).any())
    assert torch.equal(whole, runs)
