"""The steps mode of cstone_tpu_torch.multichip on the CPU: the Domain's
timestep (multichip.rank_steps) on 4 ranks in pool, dense, ragged and
windowed exchange, over bench.py's uniform sample cut to 8,000 particles
(h = default_h(8000), which keeps 57.9 neighbours a particle, cell level
3, ELL cap 64, local capacity 8,192), a cold step and 2 drift steps:

- 4 gloo processes (parallel.dist.spawn_ranks) bit-equal to the same
  function on run_ranks threads: every rank's slot records (global tree,
  assignment, focus leaves, halo flags, layout, keys, halo ids, B1 counts,
  B2 densities), capacities, window tries and comm rounds and bytes;
- every mode at every step equal by particle id to the one-rank run of
  the same particles (multichip.reference_steps): global trees bit-equal,
  counts exact, densities within rtol 1e-5 (float sums in another order);
  the window grown 1 -> 3;
- rank_steps raises when its reference is wrong (a count, a tree count);
- a cold step whose focus capacity is too short retries and then equals
  the step with room (pool and p2p, whose branches each clamp); the
  global tree's range counts of an overflowed tree equal JAX's;
- the first dense step against the JAX package: Domain.sync under
  shard_map on 4 of the 8 virtual CPU devices, then
  cell_list_neighbor_counts(impl="xla") and cell_list_sph_density on each
  rank's buffer: every slot equal, counts exact, densities within rtol
  1e-5;
- the steps mode's sizes at 4M equal bench.py's (default_h,
  default_cell_cap, the tree capacity, level 6, cap 64);
- `main(["--backend", "nccl", ...])` without a card raises, spawned or
  under torchrun's environment, and falls back to nothing."""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from cstone_tpu.domain.domain import Domain as JaxDomain
from cstone_tpu.parallel import make_mesh, rank_axis
from cstone_tpu.sfc import PERIODIC as JAX_PERIODIC
from cstone_tpu.sfc import make_box as jax_make_box
from cstone_tpu.traversal.celllist import cell_list_neighbor_counts as jax_counts
from cstone_tpu.traversal.celllist import cell_list_sph_density as jax_density
from cstone_tpu_torch import multichip
from cstone_tpu_torch.parallel import run_ranks
from cstone_tpu_torch.parallel.dist import spawn_ranks
from tests.test_torch_domain import _assert_same

import torch_dist_ranks as ranks
import torch_threads  # noqa: F401  (two intra-op threads per xdist worker)

R, N, STEPS = 4, 8000, 2
MODES = tuple(multichip.STEP_MODES)


@pytest.fixture(scope="module")
def cfg():
    return multichip.steps_config(N, R, STEPS, MODES, sim_steps=0, timed_steps=0)


@pytest.fixture(scope="module")
def reference(cfg):
    setup = multichip.uniform_setup(N, "cpu")
    ref, _ = multichip.reference_steps(setup, STEPS, cfg["level"], cfg["cell_cap"], cfg["caps"]["tree"])
    return setup, ref


@pytest.fixture(scope="module")
def threads(reference):
    return run_ranks(R, ranks.steps_modes, [N] * R, [STEPS] * R, [MODES] * R, [reference[1]] * R)


def _same(a, b, what):
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b), what
    else:
        assert a == b, what


def test_processes_equal_threads(threads):
    got = spawn_ranks(R, ranks.steps_modes, [N] * R, [STEPS] * R, [MODES] * R, backend="gloo", device="cpu",
                      timeout=60.0, deadline=300.0)
    for r in range(R):
        for name in MODES:
            want, run = threads[r][name], got[r][name]
            for k in ("caps", "window", "tries"):
                _same(want[k], run[k], f"rank {r}, {name}: {k}")
            for a, b in zip(want["comm"], run["comm"]):
                # DistComm's ragged round moves its write offsets in one
                # all_to_all of its own, which the tally counts
                _same(dict(a, all_to_all=a["all_to_all"] + a["ragged"], all_to_all_bytes=0),
                      dict(b, all_to_all_bytes=0), f"rank {r}, {name}: comm rounds")
                assert b["all_to_all_bytes"] - a["all_to_all_bytes"] == 8 * R * a["ragged"]
            for step, (a, b) in enumerate(zip(want["records"], run["records"])):
                assert a.keys() == b.keys()
                for k in a:
                    _same(a[k], b[k], f"rank {r}, {name}, step {step}: {k}")


@pytest.mark.parametrize("name", MODES)
def test_mode_equals_one_rank_by_id(threads, reference, cfg, name):
    _, ref = reference
    for step in range(1 + STEPS):
        counts = torch.full((N,), -1, dtype=torch.int32)
        rho = torch.full((N,), float("nan"))
        for r in range(R):
            rec = threads[r][name]["records"][step]
            ref_keys, ref_counts = ref[step]["tree"]
            assert torch.equal(rec["tree_keys"], ref_keys) and torch.equal(rec["tree_counts"], ref_counts)
            s, e = rec["start"], rec["end"]
            ids = rec["halo_ids"][s:e]
            assert bool((counts[ids] == -1).all()), f"{name}, step {step}: a particle owned twice"
            counts[ids] = rec["counts"][s:e]
            rho[ids] = rec["rho"][s:e]
        assert torch.equal(counts, ref[step]["counts"]), f"{name}, step {step}"
        torch.testing.assert_close(rho, ref[step]["rho"], rtol=1e-5, atol=0.0)
        assert abs(float(counts.double().mean()) - 57.9) <= 0.5
    run = threads[0][name]
    assert run["caps"] == cfg["caps"]
    if name == "window":
        assert [w for w, _ in run["tries"]] == [1, R - 1] and run["window"] == R - 1
        assert all(c["ppermute"] > 0 for c in run["comm"])
    else:
        assert [w for w, _ in run["tries"]] == [0]
    if name == "ragged":
        assert all(c["ragged"] > 0 for c in run["comm"])


def _wrong_reference(ref, what):
    bad = [dict(s) for s in ref]
    if what == "counts":
        bad[0]["counts"] = ref[0]["counts"].clone()
        bad[0]["counts"][123] += 1
    else:
        keys, counts = ref[0]["tree"]
        counts = counts.clone()
        counts[0] += 1
        bad[0]["tree"] = (keys, counts)
    return bad


@pytest.mark.parametrize("what, match", [("counts", "B1 counts differ"), ("tree", "global tree differs")])
def test_rank_steps_raises_on_a_wrong_reference(reference, cfg, what, match):
    setup, ref = reference
    bad = _wrong_reference(ref, what)

    def rank_fn(comm):
        return multichip.rank_steps(comm, setup, "p2p", "dense", 0, 0, cfg["level"], cfg["cell_cap"], cfg["caps"],
                                    bad)

    with pytest.raises(RuntimeError, match=match):
        run_ranks(R, rank_fn)


@pytest.mark.parametrize("name", ["pool", "dense"])
def test_cold_step_retries_a_short_focus_capacity(threads, reference, cfg, name):
    # the focus tree needs 512 leaves: the first try overflows (the
    # assignment may then end past the focus leaves, whose range clamps),
    # the retry grows the capacity, and the step equals the one with
    # room from the start
    setup, ref = reference
    mode, protocol, window = multichip.STEP_MODES[name]
    caps = dict(cfg["caps"], focus=300)

    def rank_fn(comm):
        return multichip.rank_steps(comm, setup, mode, protocol, window, 0, cfg["level"], cfg["cell_cap"], caps,
                                    ref)

    for r, run in enumerate(run_ranks(R, rank_fn)):
        (w0, first), (_, last) = run["tries"]
        assert first[2] > 300 and last == [0] * 7 and run["caps"]["focus"] >= first[2]
        multichip.hold_to_mode(f"rank {r}", threads[r][name]["records"][0], run["records"][0], "the roomy run")


def test_global_range_counts_of_an_overflowed_tree_match_jax():
    # a global tree that outgrew its capacity (n_nodes > capacity) and
    # queries past its last key, as an overflowing cold try of the window
    # mode makes them: the port once indexed past the count scan there
    from cstone_tpu.tree.csarray import CsArray as JaxCsArray
    from cstone_tpu_torch.domain import Domain
    from cstone_tpu_torch.ops.keys64 import from_numpy
    from cstone_tpu_torch.tree.csarray import CsArray

    cap = 8
    rng = np.random.RandomState(3)
    keys = np.concatenate([[0], np.sort(rng.randint(1, 2 ** 62, size=cap - 1)), [2 ** 63]]).astype(np.uint64)
    counts = rng.randint(0, 100, size=cap).astype(np.uint32)
    a = np.concatenate([rng.randint(0, 2 ** 62, size=6), [2 ** 63 - 1, 2 ** 63]]).astype(np.uint64)
    b = np.concatenate([a[:6] + np.uint64(2 ** 58), [2 ** 63, 2 ** 64 - 1]]).astype(np.uint64)
    for n_nodes in (5, cap, cap + 4):
        want = JaxDomain(rank=0, n_ranks=1, bucket_size=64)._global_range_counts(
            JaxCsArray(jnp.asarray(keys), jnp.asarray(counts), jnp.int32(n_nodes)), jnp.asarray(a), jnp.asarray(b))
        got = Domain._global_range_counts(
            CsArray(keys=from_numpy(keys), counts=torch.from_numpy(counts.astype(np.int64)),
                    n_nodes=torch.tensor(n_nodes)), from_numpy(a), from_numpy(b))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64), err_msg=f"n_nodes {n_nodes}")


def test_first_dense_step_matches_jax(threads, reference, cfg):
    setup, _ = reference
    cap, tc, level, cell_cap = cfg["caps"]["local"], cfg["caps"]["tree"], cfg["level"], cfg["cell_cap"]
    mesh = make_mesh(R)  # 4 of the 8 virtual CPU devices
    jbox = jax_make_box(0.0, 1.0, boundaries=JAX_PERIODIC)
    cols = np.zeros((5, R, cap), np.float32)
    n_local = np.zeros(R, np.int32)
    fields = [c.numpy() for c in setup["xyz"]] + [setup["h"].numpy(), setup["m"].numpy()]
    for r in range(R):
        n_local[r] = len(range(r, N, R))
        for c, a in enumerate(fields):
            cols[c, r, :n_local[r]] = a[r::R]

    def step(x, y, z, h, m, n):
        d = JaxDomain(rank=jax.lax.axis_index(rank_axis), n_ranks=R, bucket_size=multichip.BUCKET,
                      theta=multichip.THETA, key_dtype=jnp.uint64, tree_capacity=tc, focus_capacity=tc,
                      axis_name=rank_axis, exchange_mode="p2p", protocol="dense")
        state, res = d.sync(d.init_state(box=jbox, boundaries=(1, 1, 1)), x, y, z, h, properties=(m,),
                            n_local=n[0])
        out = (state.global_tree.keys, state.global_tree.counts, state.global_tree.n_nodes,
               state.assignment.boundaries, res.tree.leaves, res.tree.n_leaf, res.halo_flags, res.layout,
               res.start_index, res.end_index, res.n_with_halos, res.keys, res.x, res.y, res.z, res.h,
               res.properties[0], res.overflow)
        return jax.tree.map(lambda a: jnp.asarray(a)[None], out)

    fn = jax.jit(shard_map(step, mesh=mesh, in_specs=P(rank_axis), out_specs=P(rank_axis), check_vma=False))
    sharding = NamedSharding(mesh, P(rank_axis))
    args = [jax.device_put(jnp.asarray(c.reshape(-1)), sharding) for c in cols]
    out = jax.block_until_ready(fn(*args, jax.device_put(jnp.asarray(n_local), sharding)))
    (tkeys, tcounts, tn, bnd, leaves, n_leaf, flags, layout, start, end, nwh, keys, x, y, z, h, m,
     ovf) = (np.asarray(a) for a in out)

    @jax.jit
    def cells(keys, x, y, z, h, m, n_valid):
        counts, c_ovf = jax_counts(keys, x, y, z, h, jbox, level, cell_cap, n_valid=n_valid, impl="xla")
        rho, d_ovf = jax_density(keys, x, y, z, h, jbox, level, cell_cap, mass=m, n_valid=n_valid, interpret=True)
        return counts, rho, c_ovf | d_ovf

    for r in range(R):
        rec = threads[r]["dense"]["records"][0]
        assert int(ovf[r]) == 0
        nn, nl, k = int(tn[r]), int(n_leaf[r]), int(nwh[r])
        assert (int(start[r]), int(end[r]), k) == (rec["start"], rec["end"], rec["n_with_halos"])
        _assert_same(tkeys[r][:nn + 1], rec["tree_keys"], f"rank {r}: global tree keys")
        _assert_same(tcounts[r][:nn], rec["tree_counts"], f"rank {r}: global tree counts")
        _assert_same(bnd[r], rec["boundaries"], f"rank {r}: assignment")
        _assert_same(leaves[r][:nl + 1], rec["leaves"], f"rank {r}: focus leaves")
        _assert_same(flags[r][:nl], rec["halo_flags"], f"rank {r}: halo flags")
        _assert_same(layout[r][:nl + 1], rec["layout"], f"rank {r}: layout")
        _assert_same(keys[r][:k], rec["keys"], f"rank {r}: keys")
        counts, rho, c_ovf = cells(keys[r], x[r], y[r], z[r], h[r], m[r], nwh[r])
        assert not bool(c_ovf)
        _assert_same(np.asarray(counts)[:k], rec["counts"], f"rank {r}: B1 counts")
        np.testing.assert_allclose(rec["rho"].numpy(), np.asarray(rho)[:k], rtol=1e-5, atol=0.0)


def _bench_functions(*names):
    """bench.py's own functions of these names, compiled from its source
    (importing bench.py would set JAX's compilation cache for the whole
    process)."""
    src = (pathlib.Path(__file__).resolve().parent.parent / "bench.py").read_text()
    tree = ast.parse(src)
    mod = ast.Module([f for f in tree.body if isinstance(f, ast.FunctionDef) and f.name in names], [])
    ns = {}
    exec(compile(mod, "bench.py", "exec"), ns)
    return [ns[n] for n in names]


def test_sizes_at_4m_are_bench_pys():
    bench_h, bench_cap = _bench_functions("default_h", "default_cell_cap")
    big = multichip.steps_config(4_000_000, 4, 3, MODES)
    assert big["level"] == 6 and big["cell_cap"] == 64
    assert big["caps"]["local"] == 2_097_152 and big["caps"]["tree"] == big["caps"]["focus"] == 203_776
    for n in (8000, 1_000_000, 4_000_000):
        assert multichip.default_h(n) == bench_h(n)
        for level in (3, 5, 6):
            assert multichip.default_cell_cap(n, level, 3) == bench_cap(n, level, snapshots=3)
        assert multichip.tree_capacity(n) == max(4096, int(3.2 * n / 64) // 1024 * 1024 + 4096)
    assert abs(multichip.default_h(4_000_000) - 0.00756) < 1e-5


def test_nccl_without_a_card_raises(monkeypatch):
    with pytest.raises(ValueError, match="one card a rank"):
        multichip.main(["--ranks", "4", "--backend", "nccl", "--steps", "1", "--n-total", "8000"])
    for k, v in {"RANK": "0", "WORLD_SIZE": "4", "LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "4",
                 "MASTER_ADDR": "localhost", "MASTER_PORT": "1"}.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match="one card a rank"):
        multichip.main(["--backend", "nccl", "--steps", "1", "--n-total", "8000"])
    assert not torch.distributed.is_initialized()
