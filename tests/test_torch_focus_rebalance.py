"""The focus tree's rebalance decisions and key injection in the PyTorch
port against the JAX package: every function of focus/rebalance.py and
inject_keys, on trees with a focus sub-range and with mandatory keys that
sit 0, 1 and more than 1 level below their leaf (statuses CANCEL_MERGE,
REBALANCE, FAILED). Tolerance: ops, statuses, flags and leaves bit-equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cstone_tpu.focus import inject as jinj
from cstone_tpu.focus import rebalance as jreb
from cstone_tpu.tree import octree as joct
from cstone_tpu_torch.focus import inject as tinj
from cstone_tpu_torch.focus import rebalance as treb
from cstone_tpu_torch.interop import from_numpy_tree
from cstone_tpu_torch.ops.keys64 import from_numpy, to_numpy
from tests.test_torch_octree_ops import _random_tree

import torch_threads  # noqa: F401  (two intra-op threads per xdist worker)

KEY_DTYPES = [np.uint32, np.uint64]


def _setup(key_dtype, seed=5, bucket=16):
    """(jax tree, port tree, node counts, MAC flags closed under parents)."""
    jl, t, _ = _random_tree(key_dtype, "gauss", bucket=bucket, seed=seed)
    counts = np.asarray(joct.upsweep_sum(jl, t.counts, saturate_u32=True))
    rng = np.random.RandomState(seed)
    n = int(jl.n_nodes)
    parents = np.asarray(jl.parents)
    macs = np.zeros(len(counts), np.int32)
    macs[0] = 1
    for i in range(1, n):  # nodes are level-sorted: parents come first
        macs[i] = macs[parents[(i - 1) // 8]] and rng.rand() < 0.8
    return jl, from_numpy_tree(jl, device="cpu"), counts, macs


def _focus_ranges(jl):
    leaves = np.asarray(jl.leaves)
    n = int(jl.n_leaf)
    end = leaves[n]
    return [(leaves[0], end), (leaves[n // 3], leaves[2 * n // 3]), (leaves[0], leaves[n // 5]),
            (leaves[n - 7], end)]


def _signed(k):
    """A numpy unsigned key as the python int the port takes for it."""
    return int(np.array(k).view(np.int32 if np.array(k).dtype == np.uint32 else np.int64))


@pytest.mark.parametrize("key_dtype", KEY_DTYPES)
@pytest.mark.parametrize("bucket", [4, 16, 40])
def test_rebalance_decision_essential_matches_jax(key_dtype, bucket):
    jl, tl, counts, macs = _setup(key_dtype)
    tc, tm = torch.from_numpy(counts.astype(np.int64)), torch.from_numpy(macs)
    seen = set()
    for fs, fe in _focus_ranges(jl):
        jo, jc = jreb.rebalance_decision_essential(jl, jnp.asarray(counts), jnp.asarray(macs), fs, fe, bucket)
        # focus limits as 0-d key tensors and as python ints
        for a, b in ((from_numpy(np.array(fs)), from_numpy(np.array(fe))), (_signed(fs), _signed(fe))):
            to, tcv = treb.rebalance_decision_essential(tl, tc, tm, a, b, bucket)
            np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
            assert bool(tcv) == bool(jc)
        seen |= set(np.unique(np.asarray(jo)[:int(jl.n_nodes)]).tolist())
    # the tree was built for bucket 16: a smaller bucket splits, a larger one merges
    assert {4: 8, 16: 1, 40: 0}[bucket] in seen


@pytest.mark.parametrize("key_dtype", KEY_DTYPES)
def test_mac_refine_and_protect_ancestors_match_jax(key_dtype):
    jl, tl, counts, macs = _setup(key_dtype, seed=9)
    jo, jc = jreb.mac_refine_decision(jl, jnp.asarray(macs))
    to, tcv = treb.mac_refine_decision(tl, torch.from_numpy(macs))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    assert bool(tcv) == bool(jc)

    rng = np.random.RandomState(1)
    fs, fe = _focus_ranges(jl)[1]
    decided, _ = jreb.rebalance_decision_essential(jl, jnp.asarray(counts), jnp.asarray(macs), fs, fe, 40)
    random_ops = rng.choice([0, 1, 8], size=len(counts), p=[0.3, 0.6, 0.1]).astype(np.int32)
    all_one = np.ones(len(counts), np.int32)
    for ops in (np.asarray(decided), random_ops, all_one):
        jn, jc = jreb.protect_ancestors(jl, jnp.asarray(ops))
        tn, tcv = treb.protect_ancestors(tl, torch.from_numpy(ops.copy()))
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        assert bool(tcv) == bool(jc)
    assert bool(tcv)  # all ops 1: converged


def _mandatory_keys(jl, depth_below):
    """Keys `depth_below` levels below the leaf that holds them (0: leaf
    boundaries themselves), plus the two trivial keys."""
    leaves = np.asarray(jl.leaves)
    n = int(jl.n_leaf)
    dt = leaves.dtype
    picks = np.array([n // 7, n // 3, n // 2, (3 * n) // 4])
    starts, widths = leaves[picks], leaves[picks + 1] - leaves[picks]
    if depth_below == 0:
        ks = starts
    else:
        # odd multiples of the cell size `depth_below` levels down
        ks = starts + (widths >> dt.type(3 * depth_below)) * dt.type(3)
    return np.concatenate([ks, [leaves[0], leaves[n]]]).astype(dt)


@pytest.mark.parametrize("key_dtype", KEY_DTYPES)
@pytest.mark.parametrize("depth_below,want_status", [(0, jreb.CANCEL_MERGE), (1, jreb.REBALANCE), (2, jreb.FAILED)])
def test_enforce_keys_matches_jax(key_dtype, depth_below, want_status):
    jl, tl, counts, macs = _setup(key_dtype, seed=3)
    keys = _mandatory_keys(jl, depth_below)
    # merge everything outside a narrow focus, so that merges must be undone
    fs, fe = _focus_ranges(jl)[2]
    ops, _ = jreb.rebalance_decision_essential(jl, jnp.asarray(counts), jnp.zeros_like(jnp.asarray(macs)),
                                               fs, fe, 10 ** 6)
    for n_keys in (None, 2, len(keys)):
        jo, js = jreb.enforce_keys(jl, jnp.asarray(keys), ops, n_keys)
        to, ts = treb.enforce_keys(tl, from_numpy(keys), torch.from_numpy(np.array(ops)), n_keys)
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
        assert int(ts) == int(js)
    assert int(ts) == want_status
    # only trivial keys: nothing to enforce
    triv = keys[-2:]
    to, ts = treb.enforce_keys(tl, from_numpy(triv), torch.from_numpy(np.array(ops)))
    np.testing.assert_array_equal(to.numpy(), np.asarray(ops))
    assert int(ts) == jreb.CONVERGED == int(jreb.enforce_keys(jl, jnp.asarray(triv), ops)[1])


@pytest.mark.parametrize("key_dtype", KEY_DTYPES)
def test_range_count_matches_jax(key_dtype):
    jg, tg_counts, _ = _random_tree(key_dtype, "gauss", bucket=16, seed=4)
    jf, _, _ = _random_tree(key_dtype, "gauss", bucket=128, seed=4)  # a coarser tree over the same keys
    rng = np.random.RandomState(2)
    cap_f = len(np.asarray(jf.leaves)) - 1
    n_idx = 50
    idx = np.concatenate([rng.randint(0, int(jf.n_leaf), n_idx), np.full(cap_f - n_idx, cap_f + 5)]).astype(np.int32)
    idx[:n_idx] = rng.permutation(int(jf.n_leaf))[:n_idx]
    before = rng.randint(0, 9, cap_f).astype(np.uint32)
    gcounts = np.asarray(tg_counts.counts)
    j = jreb.range_count(jg.leaves, jnp.asarray(gcounts), jf.leaves, jnp.asarray(idx), n_idx, jnp.asarray(before))
    t = treb.range_count(from_numpy(np.asarray(jg.leaves)), torch.from_numpy(gcounts.astype(np.int64)),
                         from_numpy(np.asarray(jf.leaves)), torch.from_numpy(idx.astype(np.int64)), n_idx,
                         torch.from_numpy(before.astype(np.int64)))
    np.testing.assert_array_equal(t.numpy(), np.asarray(j).astype(np.int64))
    assert (np.asarray(j) != before).any()


@pytest.mark.parametrize("key_dtype", KEY_DTYPES)
@pytest.mark.parametrize("cap_extra", [400, 3])
def test_inject_keys_matches_jax(key_dtype, cap_extra):
    jl, _, _ = _random_tree(key_dtype, "gauss", bucket=64, seed=6)
    n = int(jl.n_leaf)
    # a capacity with room for the covers, and one that they overflow
    leaves = np.asarray(jl.leaves)[:n + 1 + cap_extra]
    keys = np.concatenate([_mandatory_keys(jl, 2), _mandatory_keys(jl, 4)[:3]])
    for n_keys in (None, 3):
        jo, jn = jinj.inject_keys(jnp.asarray(leaves), n, jnp.asarray(keys), n_keys)
        to, tn = tinj.inject_keys(from_numpy(leaves), n, from_numpy(keys), n_keys)
        np.testing.assert_array_equal(to_numpy(to), np.asarray(jo))
        assert int(tn) == int(jn)
    assert (int(tn) > len(leaves) - 1) == (cap_extra == 3)
    if cap_extra == 400:
        got = to_numpy(to)[:int(tn) + 1]
        assert np.isin(keys[:3], got).all() and (np.diff(got.astype(np.float64)) > 0).all()
