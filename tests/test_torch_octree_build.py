"""bench.py's tree mode (cstone_tpu_torch.octree_build) on the CPU at
30,000 keys, against the JAX package and the host C++ oracle.

For 32- and 64-bit keys, Morton and Hilbert (one parametrised test):
octree_build.octree_build_path encodes bench.py's Gaussian sample and its
drifted copy, sorts them, builds with compute_octree from bench.py's
capacity and warm start, and runs update_octree against the drifted keys
to convergence. Its keys equal JAX's compute_sfc_keys + sort; its tree
equals JAX's compute_octree at the same capacity and warm start, slot for
slot; every update step equals JAX's update_octree on JAX's own trees, the
convergence flag included; octree_build.octree_checks holds the build and
the converged update to native.compute_octree_host and the cornerstone
invariants. Also: bench.py's capacity regrow, and 32-bit keys where
leaves at the deepest level hold more than the bucket.

Tolerance: none (bit-equal)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cstone_tpu.sfc import PERIODIC as JAX_PERIODIC
from cstone_tpu.sfc import compute_sfc_keys as jax_sfc_keys
from cstone_tpu.sfc import make_box as jax_make_box
from cstone_tpu.tree import csarray as jcs
from cstone_tpu_torch import native
from cstone_tpu_torch import octree_build as ob
from cstone_tpu_torch.multichip import tree_capacity
from cstone_tpu_torch.ops.keys64 import from_numpy, to_numpy
from cstone_tpu_torch.tree import csarray as tcs

import torch_threads  # noqa: F401  (two intra-op threads per xdist worker)

N = 30_000
BUCKET = ob.BUCKET
CPU = torch.device("cpu")

needs_oracle = pytest.mark.skipif(not native.available(), reason="the host C++ oracle needs g++")


def assert_tree_same(jt, tt, what):
    np.testing.assert_array_equal(to_numpy(tt.keys), np.asarray(jt.keys), err_msg=f"{what}: keys")
    np.testing.assert_array_equal(tt.counts.numpy(), np.asarray(jt.counts).astype(np.int64), err_msg=f"{what}: counts")
    assert int(tt.n_nodes) == int(jt.n_nodes), what


@needs_oracle
@pytest.mark.parametrize("key_dtype, curve", [(np.uint32, "morton"), (np.uint32, "hilbert"),
                                              (np.uint64, "morton"), (np.uint64, "hilbert")],
                         ids=["u32-morton", "u32-hilbert", "u64-morton", "u64-hilbert"])
def test_octree_build_path_matches_jax_and_oracle(key_dtype, curve):
    run = ob.octree_build_path(CPU, N, key_dtype, curve, reps=0)
    pos, pos2 = ob.octree_sample(N)
    box = jax_make_box(0.0, 1.0, boundaries=JAX_PERIODIC)

    def jax_keys(p):
        return np.sort(np.asarray(jax_sfc_keys(*(jnp.asarray(p[:, i]) for i in range(3)), box, key_dtype, curve)))

    jkeys, jkeys2 = jax_keys(pos), jax_keys(pos2)
    np.testing.assert_array_equal(to_numpy(run["keys"]), jkeys)
    np.testing.assert_array_equal(to_numpy(run["keys2"]), jkeys2)

    cap = run["capacity"]
    assert not run["regrown"] and cap == tree_capacity(N, BUCKET)
    level = tcs.default_init_level(N, BUCKET, cap)
    assert level == jcs.default_init_level(N, BUCKET, cap) > 0
    jt = jcs.compute_octree(jnp.asarray(jkeys), BUCKET, cap, init_level=level)
    assert_tree_same(jt, run["tree"], "compute_octree")
    assert run["iters"] > 0

    flags = []
    for i, (tt, conv) in enumerate(run["steps"]):
        jt, jconv = jcs.update_octree(jt, jnp.asarray(jkeys2), BUCKET)
        assert_tree_same(jt, tt, f"update step {i}")
        assert bool(conv) == bool(jconv), f"update step {i}: convergence flag"
        flags.append(bool(conv))
    # the first step judges the build's counts (converged), the last the drifted keys' own
    assert flags[0] and flags[-1] and not any(flags[1:-1]) and len(flags) >= 2

    ob.octree_checks(f"{np.dtype(key_dtype).name} {curve}", run, N, key_dtype, curve)


@needs_oracle
def test_build_regrows_its_capacity_as_bench_does():
    keys = ob.octree_build_path(CPU, N, np.uint64, "hilbert", reps=0)["keys"]
    tree, cap, iters, regrown = ob.build_with_regrow(keys, BUCKET, 4096)
    assert regrown and cap > 4096 and iters > 0
    want_keys, want_counts = native.compute_octree_host(to_numpy(keys), BUCKET, cap)
    nn = int(tree.n_nodes)
    assert nn > 4096
    np.testing.assert_array_equal(to_numpy(tree.keys[:nn + 1]), want_keys)
    np.testing.assert_array_equal(tree.counts[:nn].numpy(), want_counts.astype(np.int64))


@needs_oracle
@pytest.mark.parametrize("key_dtype", [np.uint32, np.uint64], ids=["u32", "u64"])
def test_deepest_leaves_above_the_bucket(key_dtype):
    # bench.py's sample with 100 copies of one point and 40 within one
    # deepest 32-bit cell: a leaf at the deepest level holds them all
    pos, _ = ob.octree_sample(4000)
    pos = np.concatenate([pos, np.full((100, 3), 0.3, np.float32),
                          0.6 + np.random.RandomState(1).uniform(0, 2.0 ** -11, (40, 3)).astype(np.float32)])
    box = jax_make_box(0.0, 1.0, boundaries=JAX_PERIODIC)
    keys = np.sort(np.asarray(jax_sfc_keys(*(jnp.asarray(pos[:, i]) for i in range(3)), box, key_dtype)))
    n = keys.shape[0]
    tt = tcs.compute_octree(from_numpy(keys, CPU), BUCKET, 4096)
    jt = jcs.compute_octree(jnp.asarray(keys), BUCKET, 4096)
    assert_tree_same(jt, tt, "compute_octree")
    ob.cornerstone_ok(tt, n)
    deep = ob.fixed_point_ok(tt, BUCKET, "clustered")
    assert deep >= (2 if key_dtype == np.uint32 else 1)
    want_keys, want_counts = native.compute_octree_host(keys, BUCKET, 4096)
    nn = int(tt.n_nodes)
    np.testing.assert_array_equal(to_numpy(tt.keys[:nn + 1]), want_keys)
    np.testing.assert_array_equal(tt.counts[:nn].numpy(), want_counts.astype(np.int64))
