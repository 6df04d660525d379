"""Cornerstone and linked octrees of the PyTorch port against the JAX
package and the reference golden trees. Tolerance: bit-equal, slot for
slot over the capacity-padded arrays (the linked octree's two
permutation arrays over their valid part: padded slots there follow the
tie order of JAX's unstable sort)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cstone_tpu.tree import compute_octree as jax_compute_octree
from cstone_tpu.tree import update_octree as jax_update_octree
from cstone_tpu.tree.csarray import rebalance_decision as jax_rebalance_decision
from cstone_tpu.tree.csarray import root_tree as jax_root_tree
from cstone_tpu.tree.octree import build_linked_octree as jax_build_linked_octree
from cstone_tpu_torch.ops.keys64 import from_numpy, to_numpy
from cstone_tpu_torch.tree import build_linked_octree, compute_octree, root_tree, update_octree
from cstone_tpu_torch.tree.csarray import compute_node_counts, rebalance_decision

import torch_threads  # noqa: F401  (two intra-op threads per xdist worker)


def _sorted_keys(n, dist, key_dtype, seed):
    rng = np.random.RandomState(seed)
    if dist == "gauss":
        u = np.clip(rng.normal(0.5, 0.1, n), 0.0, 0.999999)
    else:
        u = rng.uniform(0.0, 1.0, n)
    top = 2**63 if key_dtype == np.uint64 else 2**30
    return np.sort((u * top).astype(key_dtype))


def _assert_same(jax_arr, port_arr, n=None):
    a = np.asarray(jax_arr)
    b = to_numpy(port_arr) if a.dtype in (np.uint32, np.uint64) else port_arr.numpy()
    if n is not None:
        a, b = a[:n], b[:n]
    np.testing.assert_array_equal(b, a)


def _assert_linked_same(jl, tl):
    for f in ("prefixes", "child_offsets", "parents", "level_range", "leaves"):
        _assert_same(getattr(jl, f), getattr(tl, f))
    assert int(jl.n_leaf) == int(tl.n_leaf) and int(jl.n_internal) == int(tl.n_internal)
    nn = int(jl.n_nodes)
    _assert_same(jl.internal_to_leaf, tl.internal_to_leaf, nn)
    _assert_same(jl.leaf_to_internal, tl.leaf_to_internal, nn)
    _assert_same(jl.leaf_order(), tl.leaf_order(), int(jl.n_leaf))


@pytest.mark.parametrize("key_dtype", [np.uint32, np.uint64])
@pytest.mark.parametrize("dist", ["uniform", "gauss"])
def test_compute_octree_and_linked_match_jax(key_dtype, dist):
    keys = _sorted_keys(4096, dist, key_dtype, seed=3)
    jt = jax_compute_octree(jnp.asarray(keys), 16, capacity=2048)
    tt = compute_octree(from_numpy(keys), 16, capacity=2048)
    _assert_same(jt.keys, tt.keys)
    _assert_same(jt.counts, tt.counts)
    assert int(jt.n_nodes) == int(tt.n_nodes)
    _assert_linked_same(jax_build_linked_octree(jt.keys, jt.n_nodes),
                        build_linked_octree(tt.keys, tt.n_nodes))


@pytest.mark.parametrize("key_dtype", [np.uint32, np.uint64])
def test_update_octree_from_root_matches_jax(key_dtype):
    # the root node spans the whole key range: for uint64 its range 2^63 is
    # the sign bit of the storage, which must still read as nonzero
    keys = _sorted_keys(3000, "gauss", key_dtype, seed=8)
    jt = jax_root_tree(key_dtype, 1024, n_particles=3000)
    tt = root_tree(key_dtype, 1024, n_particles=3000, device="cpu")
    jops, jconv = jax_rebalance_decision(jt.keys, jt.counts, jt.n_nodes, 16)
    tops, tconv = rebalance_decision(tt.keys, tt.counts, tt.n_nodes, 16)
    _assert_same(jops, tops)
    assert bool(jconv) == bool(tconv) is False
    for _ in range(4):
        jt, jconv = jax_update_octree(jt, jnp.asarray(keys), 16)
        tt, tconv = update_octree(tt, from_numpy(keys), 16)
        _assert_same(jt.keys, tt.keys)
        _assert_same(jt.counts, tt.counts)
        assert int(jt.n_nodes) == int(tt.n_nodes) and bool(jconv) == bool(tconv)


@pytest.mark.parametrize("suffix,bucket", [("32", 64), ("64", 16)])
def test_octree_golden(golden, suffix, bucket):
    tree = compute_octree(from_numpy(golden[f"octree{suffix}_keys_in"]), bucket)
    n = int(tree.n_nodes)
    np.testing.assert_array_equal(to_numpy(tree.keys[: n + 1]), golden[f"octree{suffix}_tree"])
    np.testing.assert_array_equal(tree.counts[:n].numpy(), golden[f"octree{suffix}_counts"])


def test_linked_octree_golden(golden):
    cstree = golden["linked32_cstree"]
    leaves = np.full(4097, cstree[-1], dtype=cstree.dtype)
    leaves[: len(cstree)] = cstree
    tree = build_linked_octree(from_numpy(leaves), len(cstree) - 1)
    n = int(tree.n_nodes)
    assert n == len(golden["linked32_prefixes"])
    np.testing.assert_array_equal(to_numpy(tree.prefixes[:n]), golden["linked32_prefixes"])
    np.testing.assert_array_equal(tree.child_offsets[:n].numpy(), golden["linked32_child_offsets"])
    np.testing.assert_array_equal(tree.level_range.numpy(), golden["linked32_level_range"])
    np.testing.assert_array_equal(tree.internal_to_leaf[:n].numpy(),
                                  golden["linked32_internal_to_leaf"].astype(np.int32))
    n_par = len(golden["linked32_parents"])
    np.testing.assert_array_equal(tree.parents[:n_par].numpy(), golden["linked32_parents"])
    np.testing.assert_array_equal(tree.leaf_order()[: int(tree.n_leaf)].numpy(),
                                  golden["linked32_leaf_order"])


def test_node_counts_clip_to_uint32():
    tree_keys = torch.tensor([0, 8, 16], dtype=torch.int64)
    codes = torch.tensor([1, 2, 3, 9], dtype=torch.int64)
    np.testing.assert_array_equal(compute_node_counts(tree_keys, codes).numpy(), [3, 1])
    np.testing.assert_array_equal(compute_node_counts(tree_keys, codes, max_count=2).numpy(), [2, 1])


def test_linked_octree_rejects_oversized_capacity():
    leaves = from_numpy(np.array([0, 2**63, 2**63], dtype=np.uint64))
    with pytest.raises(ValueError, match="cap_nodes"):
        build_linked_octree(leaves, 1, cap_nodes=5)
