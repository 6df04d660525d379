"""Tiered adaptive-h cell list of the PyTorch port against the JAX package
(interpret mode) and the O(n^2) oracle of test_neighbors.py.

Tolerances: tier levels, caps, tier indices and the cell_override ELL pack
are bit-equal; tiered counts equal the oracle and the JAX counts exactly,
and equal the port's single-level pass at levels[0] bit for bit (the
identity chip_smoke.py checks at 1M particles on the card)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cstone_tpu.sfc import PERIODIC, compute_sfc_keys
from cstone_tpu.sfc import make_box as jax_make_box
from cstone_tpu.traversal import celllist as jcl
from cstone_tpu.traversal import tiered as jt
from cstone_tpu_torch.ops.keys64 import from_numpy
from cstone_tpu_torch.sfc import make_box
from cstone_tpu_torch.traversal import celllist as tcl
from cstone_tpu_torch.traversal import tiered as tt
from cstone_tpu_torch.utils import workloads
from tests.test_neighbors import brute_force_counts

import torch_threads  # noqa: F401  (two intra-op threads per xdist worker)


def _clustered(n, periodic, seed=5, h_min=0.04):
    """Gaussian core + uniform background in [-1, 1]^3 with h growing
    outwards: tiers at levels (2, 3, 4), or (2, 3) for h_min = 0.06."""
    rng = np.random.RandomState(seed)
    nc = n // 2
    core = np.clip(rng.normal(0.0, 0.15, size=(nc, 3)), -0.99, 0.99)
    bg = rng.uniform(-1, 1, size=(n - nc, 3))
    pos = np.concatenate([core, bg]).astype(np.float32)
    h = np.clip(h_min + 0.16 * np.linalg.norm(pos, axis=1), h_min, 0.2).astype(np.float32)
    b = PERIODIC if periodic else 0
    jbox = jax_make_box(-1.0, 1.0, boundaries=b)
    keys = np.asarray(compute_sfc_keys(*(jnp.asarray(pos[:, i]) for i in range(3)), jbox, jnp.uint64))
    order = np.argsort(keys, kind="stable")
    keys = keys[order]
    assert (keys[1:] >= keys[:-1]).all(), "the tiered path takes SFC-sorted keys"
    return pos[order], h[order], keys, jbox, make_box(-1.0, 1.0, boundaries=b, device="cpu")


def _cols(pos, h):
    return tuple(np.ascontiguousarray(a) for a in (pos[:, 0], pos[:, 1], pos[:, 2], h))


@pytest.mark.parametrize("periodic", [False, True])
def test_tiered_counts_match_jax_and_bruteforce(periodic):
    # two tiers keep the JAX interpret-mode compiles to three kernel shapes
    pos, h, keys, jbox, tbox = _clustered(1500, periodic, h_min=0.06)
    levels = jt.choose_tier_levels(h, 2.0, max_tiers=3)
    assert levels == (2, 3), "setup must span two tiers"
    caps, cross = jt.tier_caps(pos, h, (-1.0, 1.0), levels)
    cols = _cols(pos, h)
    jc, jovf = jt.cell_list_neighbor_counts_tiered(
        jnp.asarray(keys), *(jnp.asarray(a) for a in cols), jbox, levels, caps, cross, interpret=True)
    tc, tovf = tt.cell_list_neighbor_counts_tiered(
        from_numpy(keys), *(torch.from_numpy(a) for a in cols), tbox, levels, caps, cross)
    assert not bool(jovf) and not bool(tovf)
    expect, _, _ = brute_force_counts(*cols, (-1, 1, -1, 1, -1, 1), periodic)
    np.testing.assert_array_equal(tc.numpy(), expect)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("n_valid", [None, 1300])
def test_three_tiers_vs_bruteforce_and_single_level(periodic, n_valid):
    pos, h, keys, _, tbox = _clustered(1500, periodic, seed=9)
    levels = tt.choose_tier_levels(h, 2.0, max_tiers=3)
    assert levels == (2, 3, 4), "setup must span three tiers"
    caps, cross = tt.tier_caps(pos, h, (-1.0, 1.0), levels)
    cols = _cols(pos, h)
    args = (from_numpy(keys),) + tuple(torch.from_numpy(a) for a in cols)
    tc, tovf = tt.cell_list_neighbor_counts_tiered(*args, tbox, levels, caps, cross, n_valid=n_valid)
    if n_valid is None:
        expect, _, _ = brute_force_counts(*cols, (-1, 1, -1, 1, -1, 1), periodic)
        np.testing.assert_array_equal(tc.numpy(), expect)
    occ = np.bincount((keys >> np.uint64(3 * (21 - levels[0]))).astype(np.int64)).max()
    sc, sovf = tcl.cell_list_neighbor_counts(*args, tbox, levels[0], int(occ), n_valid=n_valid)
    assert not bool(tovf) and not bool(sovf)
    np.testing.assert_array_equal(tc.numpy(), sc.numpy())
    if n_valid is not None:
        assert (tc[n_valid:] == 0).all()


def test_tiered_overflow_flag():
    pos, h, keys, _, tbox = _clustered(1500, True)
    levels = tt.choose_tier_levels(h, 2.0, max_tiers=3)
    caps, cross = tt.tier_caps(pos, h, (-1.0, 1.0), levels)
    args = (from_numpy(keys),) + tuple(torch.from_numpy(a) for a in _cols(pos, h))
    _, ovf = tt.cell_list_neighbor_counts_tiered(*args, tbox, levels, caps,
                                                 {k: 1 for k in cross})
    assert bool(ovf)


@pytest.mark.parametrize("case", ["clustered", "gauss_adaptive", "plummer_adaptive", "tiny", "wide"])
def test_tier_levels_caps_and_index_match_jax(case):
    if case == "clustered":
        pos, h, _, jbox, tbox = _clustered(1500, True)
        lims, side = (-1.0, 1.0), 2.0
    else:
        if case == "plummer_adaptive":
            p = workloads.plummer_coords(3000, seed=4)
            pos = np.clip(p / (2.05 * np.quantile(np.abs(p), 0.999)) + 0.5, 0.0, 1.0).astype(np.float32)
        else:
            pos = workloads.gaussian_coords(3000, (0.0, 1.0) * 3, seed=4)
        h = workloads.adaptive_h(pos, (0.0, 1.0) * 3, 100.0)
        if case == "tiny":
            h = np.full_like(h, 0.0005)
        elif case == "wide":
            h = h * np.float32(3.0)
        lims, side = (0.0, 1.0), 1.0
        jbox, tbox = jax_make_box(0.0, 1.0, boundaries=1), make_box(0.0, 1.0, boundaries=1, device="cpu")
    levels = jt.choose_tier_levels(h, side, max_tiers=3)
    assert tt.choose_tier_levels(h, side, max_tiers=3) == levels
    for slack in (1.15, 1.3):
        got = tt.tier_caps(pos, h, lims, levels, slack=slack)
        assert got == jt.tier_caps(pos, h, lims, levels, slack=slack)
    np.testing.assert_array_equal(tt._tier_index(torch.from_numpy(h), tbox, levels).numpy(),
                                  np.asarray(jt._tier_index(jnp.asarray(h), jbox, levels)))


def test_choose_tier_levels_inadmissible_raises():
    h = np.array([0.01, 0.3], np.float32)  # 2*0.3 > 2.0/4: no admissible tier
    with pytest.raises(ValueError, match="no admissible tier"):
        tt.choose_tier_levels(h, 2.0, max_tiers=3)


def test_workloads_match_jax():
    from cstone_tpu.utils import workloads as jw

    for n, seed in ((1000, 1), (2500, 42)):
        np.testing.assert_array_equal(workloads.plummer_coords(n, seed=seed), jw.plummer_coords(n, seed=seed))
        pos = workloads.gaussian_coords(n, (0.0, 1.0) * 3, seed=seed)
        np.testing.assert_array_equal(workloads.adaptive_h(pos, (0.0, 1.0) * 3, 60.0),
                                      jw.adaptive_h(pos, (0.0, 1.0) * 3, 60.0))
        np.testing.assert_array_equal(workloads.grid_density(pos, (0.0, 1.0) * 3, 4),
                                      jw.grid_density(pos, (0.0, 1.0) * 3, 4))


@pytest.mark.parametrize("tier", [0, 1, 2])
def test_cell_override_pack_matches_jax(tier):
    pos, h, keys, jbox, tbox = _clustered(1500, True)
    levels = (2, 3, 4)
    level = levels[max(tier - 1, 0)]  # the cross-pass layout: tier b at a coarser level
    tier_j = np.asarray(jt._tier_index(jnp.asarray(h), jbox, levels))
    order = np.lexsort((keys, tier_j))  # (tier, key), stable
    ks, ts = keys[order], tier_j[order]
    n_cells = 1 << (3 * level)
    cell = np.minimum(ks >> np.uint64(3 * (21 - level)), np.uint64(n_cells)).astype(np.int64)
    cell = np.where(ts < tier, -1, np.where(ts > tier, n_cells, cell)).astype(np.int32)
    cols = tuple(a[order] for a in _cols(pos, h))
    cap = 64 * (-(-int(np.bincount(cell[(cell >= 0) & (cell < n_cells)]).max()) // 64))
    jperm, _ = jcl.rowmajor_cell_perm(level)
    jp, jv, jpi, jo = jcl.ell_pack_gather(jnp.asarray(ks), jperm, tuple(jnp.asarray(a) for a in cols),
                                          cap, level, cell_override=jnp.asarray(cell))
    tperm, _ = tcl.rowmajor_cell_perm(level, device="cpu")
    tp, tv, tpi, to = tcl.ell_pack_gather(from_numpy(ks), tperm, tuple(torch.from_numpy(a) for a in cols),
                                   cap, level, cell_override=torch.from_numpy(cell))
    assert bool(jo) == bool(to) is False
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tpi.numpy(), np.asarray(jpi))
    for a, b in zip(tp, jp):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(tv.sum()) == int((ts == tier).sum())
