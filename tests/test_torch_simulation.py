"""The simulation loop of the PyTorch port (models/simulation.py) against
the JAX package's (cstone_tpu/models/simulation.py), after
tests/test_simulation.py: single steps from JAX's states carried over
(interop.from_numpy_sim_state), the conservation run, checkpoint-restore
determinism, and 8 ranks as threads against JAX's 8 shard_map ranks.

Tolerances: one step from the same state: positions and velocities
within rtol 1e-5 + atol 1e-6, energy within rtol 1e-5, momentum within
1e-6 of sum |v| (the force sums run in another order), n_local and
overflow exact; a restored run continues bit-equal; 8 ranks: n_local
exact per rank, energy and momentum as for one rank."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from cstone_tpu.domain.domain import Domain as JaxDomain
from cstone_tpu.models.simulation import sim_init as jax_sim_init
from cstone_tpu.models.simulation import sim_step as jax_sim_step
from cstone_tpu.parallel import make_mesh, rank_axis
from cstone_tpu.sfc import PERIODIC
from cstone_tpu.sfc import make_box as jax_make_box
from cstone_tpu_torch.domain import Domain
from cstone_tpu_torch.interop import from_numpy_sim_state
from cstone_tpu_torch.models import sim_diagnostics, sim_init, sim_step
from cstone_tpu_torch.parallel import run_ranks
from cstone_tpu_torch.sfc import make_box
from cstone_tpu_torch.utils import load_checkpoint, save_checkpoint
from tests.test_simulation import _setup

import torch_threads  # noqa: F401  (two intra-op threads per xdist worker)

DT = 2e-3
DOMAIN_KW = dict(bucket_size=16, tree_capacity=1024)


def _t(a):
    return torch.from_numpy(np.array(a))


def _port_start(pos, h, vel, n, device="cpu"):
    domain = Domain(device=device, **DOMAIN_KW)
    box = make_box(0.0, 1.0, boundaries=PERIODIC, device=device)
    state = sim_init(domain.init_state(box=box, boundaries=box.boundaries), *(_t(pos[:, i]) for i in range(3)),
                     _t(h), *(_t(vel[:, i]) for i in range(3)), n)
    return domain, state


def _close(t, j, what, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol, atol=atol, err_msg=what)


@pytest.fixture(scope="module")
def jax_run():
    """Five JAX steps of test_simulation.py's 1200 particles: the state
    before each step and its outputs."""
    n = 1200
    pos, h, vel = _setup(n)
    box = jax_make_box(0.0, 1.0, boundaries=PERIODIC)
    domain = JaxDomain(rank=0, n_ranks=1, key_dtype=jnp.uint64, **DOMAIN_KW)
    state = jax_sim_init(domain.init_state(box=box, boundaries=box.boundaries),
                         *(jnp.asarray(pos[:, i]) for i in range(3)), jnp.asarray(h),
                         *(jnp.asarray(vel[:, i]) for i in range(3)), n)
    step = jax.jit(lambda s: jax_sim_step(domain, s, DT))
    out = []
    for _ in range(5):
        new, e, p, ovf = step(state)
        out.append((state, new, e, p, ovf))
        state = new
    return n, pos, h, vel, out


def test_steps_match_jax_from_the_same_state(jax_run):
    n, _, _, vel, out = jax_run
    domain = Domain(device="cpu", **DOMAIN_KW)
    p_scale = float(np.abs(vel).sum())
    for i, (before, after, je, jp, jovf) in enumerate(out):
        state = from_numpy_sim_state(before, device="cpu")
        new, e, p, ovf = sim_step(domain, state, DT)
        assert int(ovf) == int(jovf) == 0, f"step {i}"
        assert int(new.n_local) == int(after.n_local) == n
        k = int(new.n_local)
        for f in ("x", "y", "z", "h", "vx", "vy", "vz"):
            _close(getattr(new, f)[:k], getattr(after, f)[:k], f"step {i}, {f}")
        np.testing.assert_allclose(float(e), float(je), rtol=1e-5)
        np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=0, atol=1e-6 * p_scale)
        # the carried domain state is JAX's
        np.testing.assert_array_equal(new.domain.global_tree.keys.numpy().view(np.uint64),
                                      np.asarray(after.domain.global_tree.keys))


def test_sim_state_carries_over_one_rank_of_a_stacked_state(jax_run):
    """from_numpy_sim_state(rank=r) takes entry r of every array of a
    state stacked along a leading rank axis (shard_map's out_specs)."""
    _, _, _, _, out = jax_run
    a, b = out[0][1], out[1][1]
    stacked = jax.tree_util.tree_map(lambda u, v: np.stack([np.asarray(u), np.asarray(v)]), a, b)
    for r, want in ((0, a), (1, b)):
        got, ref = from_numpy_sim_state(stacked, device="cpu", rank=r), from_numpy_sim_state(want, device="cpu")
        for f in ("x", "vx", "h", "n_local"):
            assert torch.equal(getattr(got, f), getattr(ref, f)), f
        assert torch.equal(got.domain.global_tree.keys, ref.domain.global_tree.keys)
        assert torch.equal(got.domain.linked.child_offsets, ref.domain.linked.child_offsets)
        assert got.domain.first_call == ref.domain.first_call and got.domain.box.boundaries == (1, 1, 1)


def test_simulation_conserves_energy_and_momentum():
    n = 1200
    pos, h, vel = _setup(n)
    domain, state = _port_start(pos, h, vel, n)
    energies, moms = [], []
    for i in range(60):
        state, e, p, ovf = sim_step(domain, state, DT)
        assert int(ovf) == 0, f"overflow at step {i}"
        energies.append(float(e))
        moms.append(p.numpy())
    e0 = energies[1]  # step 0 samples the pre-interaction energy
    drift = max(abs(e - e0) for e in energies[1:]) / abs(e0)
    assert drift < 2e-2, f"energy drift {drift}"
    p_scale = np.abs(vel).sum()
    for p in moms:
        assert np.abs(p).max() < 1e-4 * p_scale
    diag = sim_diagnostics(state)
    assert diag["n_local"] == n and 0.0 < diag["v_rms"] < 1.0


def test_checkpoint_restore_continues_bit_equal(tmp_path):
    n = 600
    pos, h, vel = _setup(n, seed=9)
    domain, state = _port_start(pos, h, vel, n)
    for _ in range(10):
        state, *_ = sim_step(domain, state, DT)
    save_checkpoint(tmp_path / "ck.pt", state)

    cont = state
    for _ in range(5):
        cont, *_ = sim_step(domain, cont, DT)
    restored = load_checkpoint(tmp_path / "ck.pt", state)
    assert restored.domain.first_call is False and restored.domain.box.boundaries == (1, 1, 1)
    for _ in range(5):
        restored, *_ = sim_step(domain, restored, DT)
    k = int(cont.n_local)
    assert int(restored.n_local) == k
    for f in ("x", "y", "z", "vx", "vy", "vz"):
        assert torch.equal(getattr(cont, f)[:k], getattr(restored, f)[:k]), f


@pytest.mark.parametrize("t0,n", [(0, 1200), (311, 530), (1000, 200)])
def test_neighbor_targets_from_an_offset(t0, n):
    """sim_step's neighbour pass targets the owned slots: targets from
    slot t0 on get the counts and neighbour sets of the full pass, every
    other slot count 0 and no neighbours."""
    from cstone_tpu_torch.traversal.neighbors import _find_neighbors_impl

    pos, h, vel = _setup(1200)
    domain, state = _port_start(pos, h, vel, 1200)
    dstate, res = domain.sync(state.domain, state.x, state.y, state.z, state.h, n_local=1200)
    view = domain.ns_view(res, dstate.box)
    kw = dict(ng_max=96, group_size=32, cand_leaf_cap=256, cand_cap=4096, chunk=16, with_indices=True)
    full_c, full_nb, _ = _find_neighbors_impl(res.x, res.y, res.z, res.h, view, dstate.box, n_targets=1200, **kw)
    c, nb, stats = _find_neighbors_impl(res.x, res.y, res.z, res.h, view, dstate.box, n_targets=n,
                                        target_offset=t0, **kw)
    assert torch.equal(c[t0:t0 + n], full_c[t0:t0 + n]) and int(c.sum()) == int(c[t0:t0 + n].sum())
    assert bool((nb[:t0] == -1).all()) and bool((nb[t0 + n:] == -1).all())
    for i in range(t0, t0 + n):
        assert set(nb[i].tolist()) == set(full_nb[i].tolist())
    with pytest.raises(ValueError, match="target_offset"):
        _find_neighbors_impl(res.x, res.y, res.z, res.h, view, dstate.box, n_targets=n, target_offset=t0 or 1,
                             use_pallas="v2", **dict(kw, with_indices=False))


N_RANKS, N_PER = 8, 150
CAP = 4 * N_PER
RANK_DOMAIN = dict(bucket_size=16, bucket_size_focus=8, tree_capacity=1024, focus_capacity=2048)
RANK_STEP = dict(group_size=16, chunk=8, cand_leaf_cap=512)


@pytest.fixture(scope="module")
def multirank():
    """test_simulation.py::test_simulation_multirank_momentum for 2 steps
    in JAX (8 shard_map ranks on the virtual CPU devices): per step the
    inputs of every rank and the outputs."""
    n = N_RANKS * N_PER
    pos, h, vel = _setup(n, seed=13)
    box = jax_make_box(0.0, 1.0, boundaries=PERIODIC)
    mesh = make_mesh(N_RANKS)
    sharding = NamedSharding(mesh, P(rank_axis))

    def pad_local(a):
        out = np.zeros((N_RANKS, CAP), dtype=a.dtype)
        out[:, :N_PER] = a.reshape(N_RANKS, N_PER)
        return out.reshape(-1)

    def fn(x, y, z, hh, vx, vy, vz, n_local):
        domain = JaxDomain(rank=jax.lax.axis_index(rank_axis), n_ranks=N_RANKS, key_dtype=jnp.uint64,
                           axis_name=rank_axis, **RANK_DOMAIN)
        state = jax_sim_init(domain.init_state(box=box, boundaries=box.boundaries), x, y, z, hh, vx, vy, vz,
                             n_local[0])
        state, e, p, ovf = jax_sim_step(domain, state, DT, **RANK_STEP)
        return (state.x, state.y, state.z, state.h, state.vx, state.vy, state.vz, state.n_local.reshape(1),
                e, p, ovf)

    step = jax.jit(shard_map(fn, mesh=mesh, in_specs=(P(rank_axis),) * 8,
                             out_specs=(P(rank_axis),) * 8 + (P(), P(), P()), check_vma=False))
    arrays = [pad_local(a) for a in (pos[:, 0], pos[:, 1], pos[:, 2], h, vel[:, 0], vel[:, 1], vel[:, 2])]
    n_local = np.full(N_RANKS, N_PER, np.int32)
    steps = []
    for _ in range(2):
        out = step(*(jax.device_put(jnp.asarray(a), sharding) for a in arrays),
                   jax.device_put(jnp.asarray(n_local), sharding))
        new_arrays = [np.asarray(a) for a in out[:7]]
        steps.append(dict(arrays=arrays, n_local=n_local, out_n_local=np.asarray(out[7]),
                          e=float(out[8]), p=np.asarray(out[9]), ovf=int(out[10])))
        arrays, n_local = new_arrays, np.asarray(out[7]).astype(np.int32)
    return vel, steps


def _port_rank_step(comm, arrays, n_local):
    domain = Domain(comm=comm, device="cpu", **RANK_DOMAIN)
    box = make_box(0.0, 1.0, boundaries=PERIODIC, device="cpu")
    state = sim_init(domain.init_state(box=box, boundaries=box.boundaries), *arrays, n_local)
    state, e, p, ovf = sim_step(domain, state, DT, **RANK_STEP)
    return int(state.n_local), float(e), p, int(ovf)


def test_multirank_steps_match_jax(multirank):
    vel, steps = multirank
    p_scale = float(np.abs(vel).sum())
    for i, st in enumerate(steps):
        per_rank = [[_t(a.reshape(N_RANKS, CAP)[r]) for a in st["arrays"]] for r in range(N_RANKS)]
        outs = run_ranks(N_RANKS, _port_rank_step, per_rank, [int(k) for k in st["n_local"]])
        assert st["ovf"] == 0 and all(o[3] == 0 for o in outs), f"step {i}"
        np.testing.assert_array_equal([o[0] for o in outs], st["out_n_local"])
        assert sum(o[0] for o in outs) == N_RANKS * N_PER
        # the reductions reach every rank with the same bits
        assert len({o[1] for o in outs}) == 1
        assert all(torch.equal(o[2], outs[0][2]) for o in outs)
        np.testing.assert_allclose(outs[0][1], st["e"], rtol=1e-5)
        np.testing.assert_allclose(outs[0][2].numpy(), st["p"], rtol=0, atol=1e-6 * p_scale)
