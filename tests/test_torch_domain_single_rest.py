"""The rest of the single-rank Domain of the PyTorch port against the JAX
package: sync(grav=True), update_expansion_centers, reapply_sync,
exchange_halos, diagnostics, compact_owned, the pool exchange mode at one
rank without a communicator, and the tree-traversal route of
sph_density_step.

Tolerance: SyncResults bit-equal slot for slot; expansion centers and
MAC spheres within rtol 1e-5 (float32 sums in another order), MAC flags
exact; density within rtol 2e-4 (the tolerance of test_torch_sph.py).
The JAX syncs are jitted, one compile each."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from cstone_tpu.domain.domain import Domain as JaxDomain
from cstone_tpu.models.sph import SphState as JaxSphState
from cstone_tpu.models.sph import sph_density_step as jax_sph_density_step
from cstone_tpu.sfc import PERIODIC
from cstone_tpu.sfc import make_box as jax_make_box
from cstone_tpu_torch.domain import Domain
from cstone_tpu_torch.models import SphState, sph_density_step
from cstone_tpu_torch.sfc import make_box
from tests.test_torch_domain import RESULT_FIELDS, _assert_same, _assert_sync_same

import torch_threads  # noqa: F401  (two intra-op threads per xdist worker)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _inputs(seed, n, h_range):
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    h = rng.uniform(*h_range, size=n).astype(np.float32)
    m = rng.uniform(0.5, 1.5, size=n).astype(np.float32)
    return pos, h, m


def _sync_both(jd, td, pos, h, m, grav=False, periodic=False, jit=True):
    b = PERIODIC if periodic else 0
    jbox, tbox = jax_make_box(-1.0, 1.0, boundaries=b), make_box(-1.0, 1.0, boundaries=b, device="cpu")
    js = jd.init_state(box=jbox if periodic else None, boundaries=jbox.boundaries)
    ts = td.init_state(box=tbox if periodic else None, boundaries=tbox.boundaries)
    sync = jax.jit(functools.partial(jd.sync, grav=grav)) if jit else functools.partial(jd.sync, grav=grav)
    js, jr = sync(js, *(jnp.asarray(pos[:, i]) for i in range(3)), jnp.asarray(h),
                  properties=(jnp.asarray(m),))
    ts, tr = td.sync(ts, *(_t(pos[:, i]) for i in range(3)), _t(h), properties=(_t(m),), grav=grav)
    return js, jr, ts, tr


@pytest.fixture(scope="module")
def grav_run():
    # the inputs of tests/test_domain.py::test_domain_sync_grav_single_rank
    pos, h, m = _inputs(23, 1200, (0.04, 0.08))
    jd = JaxDomain(rank=0, n_ranks=1, bucket_size=16, key_dtype=jnp.uint64, tree_capacity=1024, theta=0.6)
    td = Domain(bucket_size=16, tree_capacity=1024, theta=0.6, device="cpu")
    return (jd, td, pos, h, m) + _sync_both(jd, td, pos, h, m, grav=True)


def test_sync_grav_single_rank_matches_jax_and_plain(grav_run):
    jd, td, pos, h, m, js, jr, ts, tr = grav_run
    _assert_sync_same(js, jr, ts, tr)
    _assert_same(jr.properties[0], tr.properties[0], "m")
    assert int(tr.overflow) == 0
    # one rank: no leaf lies outside the focus, so gravity adds nothing
    tbox = make_box(-1.0, 1.0, device="cpu")
    ps, pr = td.sync(td.init_state(box=None, boundaries=tbox.boundaries),
                     *(_t(pos[:, i]) for i in range(3)), _t(h), properties=(_t(m),))
    for f in RESULT_FIELDS:
        torch.testing.assert_close(getattr(tr, f), getattr(pr, f), rtol=0, atol=0, msg=f)
    torch.testing.assert_close(tr.properties[0], pr.properties[0], rtol=0, atol=0)


def test_sync_grav_needs_the_mass():
    td = Domain(bucket_size=16, tree_capacity=256, device="cpu")
    x = torch.zeros(8)
    with pytest.raises(ValueError, match="mass"):
        td.sync(td.init_state(), x, x, x, x, grav=True)


def test_reapply_sync_and_exchange_halos_match_jax(grav_run):
    jd, td, pos, h, m, js, jr, ts, tr = grav_run
    field = np.arange(pos.shape[0], dtype=np.float32) * 0.5 - 7.0
    _assert_same(jd.reapply_sync(jr, jnp.asarray(field)), td.reapply_sync(tr, _t(field)), "reapply_sync")
    synced = td.reapply_sync(tr, _t(field))
    _assert_same(jd.exchange_halos(jr, jnp.asarray(synced.numpy())), td.exchange_halos(tr, synced),
                 "exchange_halos")


def test_diagnostics_match_jax(grav_run):
    jd, td, pos, h, m, js, jr, ts, tr = grav_run
    got = td.diagnostics(ts, tr)
    assert got == jd.diagnostics(js, jr)
    assert got["assigned_particles"] == pos.shape[0] and "mac_peers" not in got


def test_update_expansion_centers_matches_jax():
    # the inputs of tests/test_expansion_centers.py::test_update_expansion_centers_single_rank_oracle
    rng = np.random.RandomState(67)
    n = 1500
    pos = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    h = rng.uniform(0.04, 0.08, size=n).astype(np.float32)
    m = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
    jd = JaxDomain(rank=0, n_ranks=1, bucket_size=16, key_dtype=jnp.uint64, tree_capacity=1024, theta=0.6)
    td = Domain(bucket_size=16, tree_capacity=1024, theta=0.6, device="cpu")
    js, jr, ts, tr = _sync_both(jd, td, pos, h, m)
    _assert_sync_same(js, jr, ts, tr)
    jc, jsph, jflags, jovf = jax.jit(jd.update_expansion_centers)(js, jr, jr.properties[0])
    tc, tsph, tflags, tovf = td.update_expansion_centers(ts, tr, tr.properties[0])
    n_nodes = int(tr.tree.n_nodes)
    np.testing.assert_allclose(tc[:n_nodes].numpy(), np.asarray(jc)[:n_nodes], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tsph[:n_nodes].numpy(), np.asarray(jsph)[:n_nodes], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(tflags.numpy(), np.asarray(jflags))
    assert int(tovf) == int(jovf) == 0
    assert tflags.dtype == torch.int32 and tc.shape == tsph.shape == (tr.tree.prefixes.shape[0], 4)
    # every particle's mass is in the root
    assert float(tc[0, 3]) == pytest.approx(float(m.sum()), rel=1e-5)


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("start", [0, 1, 377, 999])
def test_compact_owned_is_a_roll_without_host_reads(start):
    field = torch.arange(1000, dtype=torch.float32) * 3.0 - 11.0
    res = type("Res", (), {"start_index": torch.tensor(start)})()
    with _Ops() as ops:
        out = Domain.compact_owned(res, field)
    assert not any("_local_scalar_dense" in n for n in ops.names), ops.names
    torch.testing.assert_close(out, torch.roll(field, -start, 0), rtol=0, atol=0)


@pytest.mark.parametrize("grav", [False, True])
def test_pool_mode_at_one_rank_matches_jax(grav):
    # exchange_mode="pool" with one rank and no communicator (JAX:
    # axis_name=None): the pool is the rank's own sorted particles
    pos, h, m = _inputs(31, 1000, (0.04, 0.08))
    kw = dict(bucket_size=16, bucket_size_focus=8, tree_capacity=512, focus_capacity=1024,
              exchange_mode="pool")
    jd = JaxDomain(rank=0, n_ranks=1, key_dtype=jnp.uint64, **kw)
    td = Domain(device="cpu", **kw)
    js, jr, ts, tr = _sync_both(jd, td, pos, h, m, grav=grav, periodic=True)
    for f in RESULT_FIELDS[:-1] + ("global_ids", "pool_perm"):
        _assert_same(getattr(jr, f), getattr(tr, f), f)
    _assert_same(jr.tree.leaves, tr.tree.leaves, "tree.leaves")
    assert int(tr.overflow) == 0 and int(tr.end_index) - int(tr.start_index) == pos.shape[0]
    field = np.arange(pos.shape[0], dtype=np.float32)
    _assert_same(jd.reapply_sync(jr, jnp.asarray(field)), td.reapply_sync(tr, _t(field)), "reapply_sync")


@pytest.mark.parametrize("periodic", [False, True])
def test_sph_tree_path_matches_jax(periodic):
    pos, h, m = _inputs(41, 1200, (0.05, 0.1))
    b = PERIODIC if periodic else 0
    jd = JaxDomain(rank=0, n_ranks=1, bucket_size=16, key_dtype=jnp.uint64, tree_capacity=1024)
    td = Domain(bucket_size=16, tree_capacity=1024, device="cpu")
    jbox, tbox = jax_make_box(-1.0, 1.0, boundaries=b), make_box(-1.0, 1.0, boundaries=b, device="cpu")
    n = pos.shape[0]
    js = JaxSphState(domain=jd.init_state(box=jbox if periodic else None, boundaries=jbox.boundaries),
                     x=jnp.asarray(pos[:, 0]), y=jnp.asarray(pos[:, 1]), z=jnp.asarray(pos[:, 2]),
                     h=jnp.asarray(h), m=jnp.asarray(m), n_local=jnp.int32(n))
    ts = SphState(domain=td.init_state(box=tbox if periodic else None, boundaries=tbox.boundaries),
                  x=_t(pos[:, 0]), y=_t(pos[:, 1]), z=_t(pos[:, 2]), h=_t(h), m=_t(m),
                  n_local=torch.tensor(n))
    kw = dict(ng_max=128, group_size=32, cand_leaf_cap=128, cand_cap=2048)
    jstep = jax.jit(functools.partial(jax_sph_density_step, jd, **kw))
    for _ in range(2):
        js, jrho, jres = jstep(js)
        ts, trho, tres = sph_density_step(td, ts, **kw)
        for f in ("keys", "x", "h", "start_index", "end_index", "overflow"):
            _assert_same(getattr(jres, f), getattr(tres, f), f)
        assert int(tres.overflow) == 0
        jrho = np.asarray(jrho)
        np.testing.assert_allclose(trho.numpy(), jrho, rtol=2e-4, atol=1e-6 * jrho.max())
        _assert_same(js.x, ts.x, "next x")
        assert int(ts.n_local) == int(js.n_local) == n
    # a too-small neighbour list folds into the overflow
    _, _, small = sph_density_step(td, ts, **dict(kw, ng_max=4))
    assert int(small.overflow) == 1
