"""Linked-octree queries and the upsweep of the PyTorch port against the
JAX package and the reference golden tree: locate_node, containing_node
(one batched ancestor lookup here, a level walk there), upsweep_sum with
uint32 saturation, and the generic upsweep on source centers. Tolerance:
integers and keys bit-equal; float centers rtol 1e-6 (the leaf sums run
in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cstone_tpu.focus import source_center as jsc
from cstone_tpu.sfc.keys import make_prefix as jax_make_prefix
from cstone_tpu.tree import octree as joct
from cstone_tpu.tree.csarray import compute_octree as jax_compute_octree
from cstone_tpu_torch.focus import source_center as tsc
from cstone_tpu_torch.interop import from_numpy_tree
from cstone_tpu_torch.ops.keys64 import from_numpy
from cstone_tpu_torch.tree import octree as toct
from tests.test_torch_tree import _sorted_keys

import torch_threads  # noqa: F401  (two intra-op threads per xdist worker)


def _golden_tree(golden, cap_leaf=4096):
    cstree = golden["linked32_cstree"]
    leaves = np.full(cap_leaf + 1, cstree[-1], dtype=cstree.dtype)
    leaves[:len(cstree)] = cstree
    return joct.build_linked_octree(jnp.asarray(leaves), jnp.int32(len(cstree) - 1))


def _random_tree(key_dtype, dist, bucket=16, n=4000, cap=2048, seed=3):
    keys = _sorted_keys(n, dist, key_dtype, seed)
    t = jax_compute_octree(jnp.asarray(keys), bucket, capacity=cap)
    return joct.build_linked_octree(t.keys, t.n_nodes), t, keys


def _node_queries(jl, seed):
    """Placeholder-bit keys of nodes the tree holds, of cells below its
    leaves, and of the smallest cells starting at random keys."""
    rng = np.random.RandomState(seed)
    n = int(jl.n_nodes)
    pref = np.asarray(jl.prefixes)[:n]
    dt = pref.dtype
    lmax = 10 if dt == np.uint32 else 21
    deep = []
    for p in pref[rng.randint(0, n, 200)]:
        room = lmax - (int(p).bit_length() - 1) // 3
        down = int(rng.randint(0, room + 1))
        deep.append((int(p) << (3 * down)) | int(rng.randint(0, 8 ** down)) if down else int(p))
    rand = rng.randint(0, 1 << 30, 100).astype(dt) << dt.type(3 * lmax - 30)
    rand = np.asarray(jax_make_prefix(jnp.asarray(rand)))
    return np.concatenate([pref[rng.randint(0, n, 100)], np.array(deep, dt), rand, np.array([1], dt)])


@pytest.mark.parametrize("which", ["golden", "uint32-gauss", "uint64-uniform", "uint64-gauss"])
def test_locate_and_containing_node_match_jax(golden, which):
    if which == "golden":
        jl = _golden_tree(golden)
    else:
        kd, dist = which.split("-")
        jl = _random_tree(np.dtype(kd).type, dist)[0]
    tl = from_numpy_tree(jl, device="cpu")
    q = _node_queries(jl, seed=11)
    np.testing.assert_array_equal(toct.locate_node(tl, from_numpy(q)).numpy(),
                                  np.asarray(joct.locate_node(jl, jnp.asarray(q))))
    got = toct.containing_node(tl, from_numpy(q))
    np.testing.assert_array_equal(got.numpy(), np.asarray(joct.containing_node(jl, jnp.asarray(q))))
    # the chain of ancestors is a prefix of the levels and ends at that node
    idx, hit = toct.ancestor_chain(tl, from_numpy(q))
    depth = hit.sum(1)
    assert bool((hit == (torch.arange(hit.shape[1]) < depth[:, None])).all())
    assert bool((idx[:, 0] == 0).all())


def test_upsweep_counts_golden(golden):
    jl = _golden_tree(golden)
    counts = np.pad(golden["linked32_counts"].astype(np.int64), (0, 4096 - len(golden["linked32_counts"])))
    node_counts = toct.upsweep_sum(from_numpy_tree(jl, device="cpu"), torch.from_numpy(counts), saturate_u32=True)
    n = int(jl.n_nodes)
    np.testing.assert_array_equal(node_counts[:n].numpy(), golden["linked32_node_counts"].astype(np.int64))


@pytest.mark.parametrize("saturate", [True, False])
@pytest.mark.parametrize("key_dtype", [np.uint32, np.uint64])
def test_upsweep_sum_matches_jax(key_dtype, saturate):
    jl, t, _ = _random_tree(key_dtype, "gauss", seed=5)
    tl = from_numpy_tree(jl, device="cpu")
    counts = np.asarray(t.counts).astype(np.int64)
    if saturate:
        # counts near 2^32: sums of siblings pass it and must clamp, level after level
        counts = np.where(np.arange(len(counts)) % 5 == 0, counts + (1 << 31), counts)
        counts = np.where(np.arange(len(counts)) < int(t.n_nodes), counts, 0)
    j = joct.upsweep_sum(jl, jnp.asarray(counts.astype(np.uint32)), saturate_u32=saturate)
    got = toct.upsweep_sum(tl, torch.from_numpy(counts), saturate_u32=saturate)
    want = np.asarray(j).astype(np.int64)
    if saturate:
        assert want.max() == 0xFFFFFFFF
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_array_equal(got.numpy(), want)
        assert int(got[0]) == counts.sum()


def test_source_centers_match_jax():
    jl, t, keys = _random_tree(np.uint64, "uniform", seed=7)
    tl = from_numpy_tree(jl, device="cpu")
    rng = np.random.RandomState(8)
    n = len(keys)
    x, y, z = (rng.uniform(-1, 1, n).astype(np.float32) for _ in range(3))
    m = rng.uniform(0.5, 2.0, n).astype(np.float32) * np.where(rng.rand(n) < 0.1, -1, 1).astype(np.float32)
    cap_leaf = len(np.asarray(t.counts))
    layout = np.concatenate([[0], np.cumsum(np.asarray(t.counts).astype(np.int64))])
    jleaf = jsc.compute_leaf_source_centers(*(jnp.asarray(a) for a in (x, y, z, m)),
                                            jnp.asarray(layout.astype(np.int32)), cap_leaf)
    tleaf = tsc.compute_leaf_source_centers(*(torch.from_numpy(a) for a in (x, y, z, m)),
                                            torch.from_numpy(layout), cap_leaf)
    np.testing.assert_allclose(tleaf.numpy(), np.asarray(jleaf), rtol=1e-6, atol=1e-6)
    # the same leaf centers through both upsweeps
    jnode = jsc.upsweep_centers(jl, jleaf)
    tnode = tsc.upsweep_centers(tl, torch.from_numpy(np.array(jleaf)))
    np.testing.assert_allclose(tnode.numpy(), np.asarray(jnode), rtol=1e-6, atol=1e-6)
