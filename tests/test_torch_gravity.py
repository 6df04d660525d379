"""Barnes-Hut monopole gravity of the PyTorch port (models/nbody.py)
against the JAX package and direct summation, after
tests/test_gravity.py (n = 3000, theta 0.4 and 1e-3), and on the
Domain's route: sync(grav=True) + update_expansion_centers.

Tolerances: accelerations within 1e-4 of |a| per particle of JAX's (the
sums run in another order: breadth first, atomics); against float64
direct summation the median and 95th percentile relative errors of
test_gravity.py; overflow exact."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cstone_tpu.domain.domain import Domain as JaxDomain
from cstone_tpu.focus.source_center import compute_leaf_source_centers as jax_leaf_centers
from cstone_tpu.focus.source_center import set_mac_radii as jax_set_mac_radii
from cstone_tpu.focus.source_center import upsweep_centers as jax_upsweep_centers
from cstone_tpu.models.nbody import gravity_monopole as jax_gravity
from cstone_tpu.sfc import make_box as jax_make_box
from cstone_tpu.traversal.geometry import node_geometry as jax_node_geometry
from cstone_tpu_torch.domain import Domain
from cstone_tpu_torch.focus.source_center import compute_leaf_source_centers, set_mac_radii, upsweep_centers
from cstone_tpu_torch.interop import from_numpy_tree
from cstone_tpu_torch.models.nbody import gravity_monopole
from cstone_tpu_torch.sfc import make_box
from cstone_tpu_torch.traversal.geometry import node_geometry
from tests.test_gravity import _setup, direct_gravity

import torch_threads  # noqa: F401  (two intra-op threads per xdist worker)

KW = dict(group_size=32, leaf_cap=1024, cand_cap=4096, chunk=8)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel_to(a, ref):
    """Per-particle |a - ref| / |ref|."""
    return np.linalg.norm(a - ref, axis=1) / (np.linalg.norm(ref, axis=1) + 1e-12)


def _acc(ax, ay, az):
    return np.stack([np.asarray(a, dtype=np.float64) for a in (ax, ay, az)], axis=-1)


@pytest.fixture(scope="module")
def setup():
    n = 3000
    pos, m, box, tree, linked, layout = _setup(n)
    return n, pos, m, box, linked, layout, direct_gravity(pos.astype(np.float64), m.astype(np.float64))


@pytest.mark.parametrize("theta,tol", [(0.4, 2e-2), (1e-3, 1e-5)])
def test_gravity_matches_jax_and_direct(setup, theta, tol):
    n, pos, m, box, linked, layout, ref = setup
    jx = [jnp.asarray(pos[:, i]) for i in range(3)]
    jm = jnp.asarray(m)
    jcent = jax_upsweep_centers(linked, jax_leaf_centers(*jx, jm, layout, 2048))
    jsph = jax_set_mac_radii(linked, jcent, 1.0 / theta, box)
    jgc, jgs = jax_node_geometry(linked, box)
    *ja, jovf = jax_gravity(*jx, jm, linked, layout, jcent, jsph[:, 3], jgc, jgs, box, n_targets=n, **KW)

    tlinked = from_numpy_tree(linked, device="cpu")
    tlayout = _t(layout).long()
    tbox = make_box(-1.0, 1.0, device="cpu")
    tx = [_t(pos[:, i]) for i in range(3)]
    tm = _t(m)
    tcent = upsweep_centers(tlinked, compute_leaf_source_centers(*tx, tm, tlayout, 2048))
    tsph = set_mac_radii(tlinked, tcent, 1.0 / theta, tbox)
    tgc, tgs = node_geometry(tlinked, tbox)
    *ta, tovf = gravity_monopole(*tx, tm, tlinked, tlayout, tcent, tsph[:, 3], tgc, tgs, tbox, n_targets=n, **KW)

    assert int(tovf) == int(jovf) == 0
    a, aj = _acc(*ta), _acc(*ja)
    assert _rel_to(a, aj).max() < 1e-4
    err = _rel_to(a, ref)
    assert np.median(err) < tol, f"median rel err {np.median(err)}"
    assert np.percentile(err, 95) < 10 * tol


def test_gravity_overflow_reports_short_caps(setup):
    n, pos, m, box, linked, layout, _ = setup
    tlinked = from_numpy_tree(linked, device="cpu")
    tlayout = _t(layout).long()
    tbox = make_box(-1.0, 1.0, device="cpu")
    tx = [_t(pos[:, i]) for i in range(3)]
    tm = _t(m)
    tcent = upsweep_centers(tlinked, compute_leaf_source_centers(*tx, tm, tlayout, 2048))
    tsph = set_mac_radii(tlinked, tcent, 1.0 / 0.4, tbox)
    args = (*tx, tm, tlinked, tlayout, tcent, tsph[:, 3], None, None, tbox)
    kw = dict(group_size=32, chunk=8, n_targets=n)
    *_, ovf_cand = gravity_monopole(*args, leaf_cap=1024, cand_cap=64, **kw)
    *_, ovf_leaf = gravity_monopole(*args, leaf_cap=2, cand_cap=4096, **kw)
    *_, ovf_none = gravity_monopole(*args, leaf_cap=1024, cand_cap=4096, **kw)
    assert int(ovf_cand) > 64 and 2 < int(ovf_leaf) <= 1024 and int(ovf_none) == 0


def test_gravity_domain_route_matches_jax():
    """sync(grav=True) + update_expansion_centers + gravity_monopole on
    the focus tree, the route of a gravity client, in both packages."""
    rng = np.random.RandomState(21)
    n = 2000
    pos = rng.normal(0, 0.25, size=(n, 3)).clip(-0.99, 0.99).astype(np.float32)
    m = rng.uniform(0.5, 1.5, size=n).astype(np.float32)
    h = np.full(n, 0.02, np.float32)
    kw = dict(bucket_size=32, theta=0.4, tree_capacity=1024)

    jd = JaxDomain(rank=0, n_ranks=1, key_dtype=jnp.uint64, **kw)
    jbox = jax_make_box(-1.0, 1.0)
    js, jr = jax.jit(functools.partial(jd.sync, grav=True))(
        jd.init_state(box=jbox), *(jnp.asarray(pos[:, i]) for i in range(3)), jnp.asarray(h),
        properties=(jnp.asarray(m),))
    jc, jsph, _, _ = jax.jit(jd.update_expansion_centers)(js, jr, jr.properties[0])
    jgc, jgs = jax_node_geometry(jr.tree, js.box)
    *ja, jovf = jax_gravity(jr.x, jr.y, jr.z, jr.properties[0], jr.tree, jr.layout, jc, jsph[:, 3], jgc, jgs,
                            js.box, n_targets=n, **KW)

    td = Domain(device="cpu", **kw)
    tbox = make_box(-1.0, 1.0, device="cpu")
    ts, tr = td.sync(td.init_state(box=tbox), *(_t(pos[:, i]) for i in range(3)), _t(h), properties=(_t(m),),
                     grav=True)
    tc, tsph, _, tcovf = td.update_expansion_centers(ts, tr, tr.properties[0])
    tgc, tgs = node_geometry(tr.tree, ts.box)
    *ta, tovf = gravity_monopole(tr.x, tr.y, tr.z, tr.properties[0], tr.tree, tr.layout, tc, tsph[:, 3], tgc, tgs,
                                 ts.box, n_targets=n, **KW)

    assert int(tovf) == int(jovf) == 0 and int(tcovf) == 0 and int(tr.overflow) == 0
    np.testing.assert_array_equal(tr.x.numpy(), np.asarray(jr.x))
    nn = int(tr.tree.n_nodes)
    np.testing.assert_allclose(tc[:nn].numpy(), np.asarray(jc)[:nn], rtol=1e-5, atol=1e-7)
    a, aj = _acc(*ta), _acc(*ja)
    assert _rel_to(a, aj).max() < 1e-4
    order = tr.x.numpy(), tr.y.numpy(), tr.z.numpy()
    ref = direct_gravity(np.stack(order, -1).astype(np.float64), tr.properties[0].numpy().astype(np.float64))
    err = _rel_to(a, ref)
    assert np.median(err) < 2e-2 and np.percentile(err, 95) < 0.2
