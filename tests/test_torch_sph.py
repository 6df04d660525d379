"""SPH density step (cell-list path) of the PyTorch port against the JAX
package: sync + fused density over carried steps, and a step started from
the JAX state. Tolerance: the synced particle data bit-equal, density
within rtol 2e-4 (the tolerance of test_sph_celllist.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cstone_tpu_torch
from cstone_tpu.domain.domain import Domain as JaxDomain
from cstone_tpu.models.sph import SphState as JaxSphState
from cstone_tpu.models.sph import sph_density_step as jax_sph_density_step
from cstone_tpu.sfc import PERIODIC
from cstone_tpu.sfc import make_box as jax_make_box
from cstone_tpu_torch.domain import Domain
from cstone_tpu_torch.models import SphState, sph_density_step
from cstone_tpu_torch.ops.keys64 import to_numpy
from cstone_tpu_torch.sfc import make_box

import torch_threads  # noqa: F401  (two intra-op threads per xdist worker)

N = 1500
LEVEL = 2  # cell side 0.5 >= 2 * max(h) = 0.2
CAP = 64


def _initial(periodic):
    rng = np.random.RandomState(41)
    pos = rng.uniform(-1, 1, size=(N, 3)).astype(np.float32)
    h = rng.uniform(0.05, 0.1, size=N).astype(np.float32)
    m = rng.uniform(0.5, 1.5, size=N).astype(np.float32)
    b = PERIODIC if periodic else 0
    jd = JaxDomain(rank=0, n_ranks=1, bucket_size=16, key_dtype=jnp.uint64, tree_capacity=1024)
    td = Domain(bucket_size=16, tree_capacity=1024, device="cpu")
    jbox, tbox = jax_make_box(-1.0, 1.0, boundaries=b), make_box(-1.0, 1.0, boundaries=b, device="cpu")
    jstate = JaxSphState(
        domain=jd.init_state(box=jbox if periodic else None, boundaries=jbox.boundaries),
        x=jnp.asarray(pos[:, 0]), y=jnp.asarray(pos[:, 1]), z=jnp.asarray(pos[:, 2]),
        h=jnp.asarray(h), m=jnp.asarray(m), n_local=jnp.int32(N))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    tstate = SphState(
        domain=td.init_state(box=tbox if periodic else None, boundaries=tbox.boundaries),
        x=t(pos[:, 0]), y=t(pos[:, 1]), z=t(pos[:, 2]), h=t(h), m=t(m),
        n_local=torch.tensor(N))
    return jd, td, jstate, tstate


def _assert_step_same(jout, tout):
    (js, jrho, jres), (ts, trho, tres) = jout, tout
    np.testing.assert_array_equal(to_numpy(tres.keys), np.asarray(jres.keys))
    for f in ("x", "y", "z", "h"):
        np.testing.assert_array_equal(getattr(tres, f).numpy(), np.asarray(getattr(jres, f)))
    np.testing.assert_array_equal(tres.properties[0].numpy(), np.asarray(jres.properties[0]))
    assert int(tres.overflow) == int(jres.overflow) == 0
    jrho = np.asarray(jrho)
    np.testing.assert_allclose(trho.numpy(), jrho, rtol=2e-4, atol=1e-6 * jrho.max())
    np.testing.assert_array_equal(ts.x.numpy(), np.asarray(js.x))
    assert int(ts.n_local) == int(js.n_local)


@pytest.mark.parametrize("periodic", [True, False])
def test_sph_step_matches_jax(periodic):
    jd, td, js, ts = _initial(periodic)
    for _ in range(2):
        jout = jax_sph_density_step(jd, js, cell_level=LEVEL, cell_cap=CAP, interpret=True)
        tout = sph_density_step(td, ts, cell_level=LEVEL, cell_cap=CAP)
        _assert_step_same(jout, tout)
        js, ts = jout[0], tout[0]


def test_sph_step_continues_from_jax_state():
    jd, td, js, _ = _initial(True)
    js, _, _ = jax_sph_density_step(jd, js, cell_level=LEVEL, cell_cap=CAP, interpret=True)
    ts = cstone_tpu_torch.from_numpy_state(js, device="cpu")
    jout = jax_sph_density_step(jd, js, cell_level=LEVEL, cell_cap=CAP, interpret=True)
    tout = sph_density_step(td, ts, cell_level=LEVEL, cell_cap=CAP)
    _assert_step_same(jout, tout)


def test_tree_path_is_not_ported():
    _, td, _, ts = _initial(True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        sph_density_step(td, ts)
