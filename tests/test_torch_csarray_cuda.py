"""The cornerstone fixed point on the card: the three kernels of
csrc/csarray.cu (counts, decide, emit, through tree/csarray's dispatch)
against the plain functions run on the same card on the same inputs, and
against the plain route on the CPU, bit for bit over the whole padded
capacity: the int64 counts, the int32 op codes, the 0-d bool convergence
flag, the new keys padded with nodeRange(0) and the new node count, for
uint32 and uint64 keys; one launch a call, counted by the wrapper and by
the trace counter `csarray.kernel` (`csarray.plain` never), and no host
read inside a call (torch.cuda.set_sync_debug_mode "error").

Cases: uniform trees at levels 1-5 over a Gaussian sample (splits and
merges), the 2M Gaussian tree of the `gauss-2M-adaptive-h` configuration
(bucket 64, capacity 131,072) after a drift of its particles, the root
tree, a root tree whose rebalance passes its capacity (the new node count
above it, as the loop that stops on it needs), n_codes below the key
array's length (as an int and as a tensor), counts clipped by max_count,
a leaf split into 4096, and whole converge_global_octree runs from the
root and warm, node for node against the plain run on the CPU. Skips
without an NVIDIA GPU and nvcc; chip_smoke.py's phase 20 runs the kernels
at the benchmark cells' shapes. Tolerance: every output exact."""

import functools

import numpy as np
import pytest
import torch

from cstone_tpu_torch.ops import csarray as kernels
from cstone_tpu_torch.ops.cuda_lib import nvcc_path
from cstone_tpu_torch.ops.keys64 import usort
from cstone_tpu_torch.parallel.global_tree import converge_global_octree
from cstone_tpu_torch.sfc import compute_sfc_keys, make_box
from cstone_tpu_torch.sfc.keys import max_tree_level
from cstone_tpu_torch.tree.csarray import (CsArray, compute_node_counts, compute_node_counts_plain, compute_octree,
                                           rebalance_decision, rebalance_decision_plain, rebalance_tree,
                                           rebalance_tree_plain, root_tree, uniform_tree)
from cstone_tpu_torch.utils import trace

pytestmark = pytest.mark.cuda

KEYS = [np.uint32, np.uint64]
GAUSS_N, GAUSS_CAP, GAUSS_BUCKET = 2_000_000, 131_072, 64


@pytest.fixture(scope="module")
def dev():
    try:
        nvcc_path()
    except RuntimeError:
        pytest.skip("needs an NVIDIA GPU and nvcc")
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


def _codes(n: int, key_dtype, sigma: float, seed: int, drift: float = 0.0) -> torch.Tensor:
    """Sorted keys of n points, normal about the centre, each moved by up to
    `drift` a coordinate, clamped: encoded on the card, returned on the CPU."""
    rng = np.random.default_rng(seed)
    pos = rng.normal(0.5, sigma, (n, 3)) + rng.uniform(-drift, drift, (n, 3))
    pos = torch.from_numpy(np.clip(pos, 0, 1 - 1e-7).astype(np.float32)).cuda()
    box = make_box(0.0, 1.0, device="cuda")
    return usort(compute_sfc_keys(pos[:, 0], pos[:, 1], pos[:, 2], box, key_dtype))[0].cpu()


def _same(got, want, what):
    assert got.dtype == want.dtype and got.shape == want.shape, (what, got.dtype, want.dtype, got.shape, want.shape)
    assert torch.equal(got.cpu(), want.cpu()), (what, int((got.cpu() != want.cpu()).sum()))


def _one_launch(name, fn):
    """fn() through the kernel route: one launch of `name`, `csarray.kernel`
    once, no host read."""
    torch.cuda.synchronize()
    before = kernels.launches()
    with trace.collect() as tally:
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    after = kernels.launches()
    assert {k: after[k] - before[k] for k in after} == {"counts": 0, "decide": 0, "emit": 0, name: 1}
    assert tally.read()["counts"] == {"csarray.kernel": 1}
    return out


def _on_cpu(fn):
    with trace.collect() as tally:
        out = fn()
    assert tally.read()["counts"] == {"csarray.plain": 1}
    return out


def _held_to_plain(dev, keys_cpu, codes_cpu, n_nodes, bucket, max_count=0xFFFFFFFF, n_codes=None):
    """One count, decision and emission on the card against the plain
    functions on the card and the plain route on the CPU; returns the
    card's (counts, ops, converged, new_keys, new_n)."""
    keys, codes = keys_cpu.to(dev), codes_cpu.to(dev)
    n_card = torch.as_tensor(n_nodes, dtype=torch.int64).to(dev)
    nc_card = n_codes.to(dev) if isinstance(n_codes, torch.Tensor) else n_codes

    counts = _one_launch("counts", lambda: compute_node_counts(keys, codes, max_count, nc_card))
    _same(counts, compute_node_counts_plain(keys, codes, max_count, nc_card), "counts, plain on the card")
    counts_cpu = _on_cpu(lambda: compute_node_counts(keys_cpu, codes_cpu, max_count, n_codes))
    _same(counts, counts_cpu, "counts, plain on the CPU")

    ops, conv = _one_launch("decide", lambda: rebalance_decision(keys, counts, n_card, bucket))
    want_ops, want_conv = rebalance_decision_plain(keys, counts, n_card, bucket)
    _same(ops, want_ops, "ops, plain on the card")
    _same(conv, want_conv, "converged, plain on the card")
    ops_cpu, conv_cpu = _on_cpu(lambda: rebalance_decision(keys_cpu, counts_cpu, int(n_nodes), bucket))
    _same(ops, ops_cpu, "ops, plain on the CPU")
    _same(conv, conv_cpu, "converged, plain on the CPU")

    new_keys, new_n = _one_launch("emit", lambda: rebalance_tree(keys, ops, n_card))
    want_keys, want_n = rebalance_tree_plain(keys, ops, n_card)
    _same(new_keys, want_keys, "new keys, plain on the card")
    _same(new_n, want_n, "new node count, plain on the card")
    keys_c, n_c = _on_cpu(lambda: rebalance_tree(keys_cpu, ops_cpu, int(n_nodes)))
    _same(new_keys, keys_c, "new keys, plain on the CPU")
    _same(new_n, n_c, "new node count, plain on the CPU")
    return counts, ops, conv, new_keys, new_n


@pytest.mark.parametrize("key_dtype", KEYS)
@pytest.mark.parametrize("level", [1, 2, 3, 4, 5])
def test_uniform_levels(dev, key_dtype, level):
    tree = uniform_tree(key_dtype, level, 8 ** level + 77, device="cpu")
    codes = _codes(60_000, key_dtype, 0.1, seed=level)
    _, ops, conv, _, new_n = _held_to_plain(dev, tree.keys, codes, tree.n_nodes, 16)
    if level >= 3:  # the sample is clustered: the rebalance both splits and merges
        assert bool((ops == 0).any()) and bool((ops >= 8).any()) and not bool(conv)


@functools.cache
def _gauss_tree(key_dtype):
    """The 2M Gaussian sample's keys, their converged tree (the plain route
    on the CPU) and the keys of the sample drifted by up to a quarter of its
    mean spacing at the centre, all on the CPU."""
    codes = _codes(GAUSS_N, key_dtype, 0.2, seed=42)
    tree = compute_octree(codes, GAUSS_BUCKET, capacity=GAUSS_CAP)
    return codes, tree, _codes(GAUSS_N, key_dtype, 0.2, seed=42, drift=1e-3)


@pytest.mark.parametrize("key_dtype", KEYS)
def test_gaussian_2m_tree_after_a_drift(dev, key_dtype):
    _, tree, drifted = _gauss_tree(key_dtype)
    _, ops, conv, _, _ = _held_to_plain(dev, tree.keys, drifted, tree.n_nodes, GAUSS_BUCKET)
    assert int(tree.n_nodes) > 50_000 and not bool(conv) and bool((ops != 1).any())


@pytest.mark.parametrize("key_dtype", KEYS)
def test_gaussian_2m_tree_at_its_fixed_point(dev, key_dtype):
    codes, tree, _ = _gauss_tree(key_dtype)
    _, _, conv, new_keys, new_n = _held_to_plain(dev, tree.keys, codes, tree.n_nodes, GAUSS_BUCKET)
    assert bool(conv) and int(new_n) == int(tree.n_nodes) and torch.equal(new_keys.cpu(), tree.keys)


@pytest.mark.parametrize("key_dtype", KEYS)
def test_root_tree(dev, key_dtype):
    tree = root_tree(key_dtype, 64, device="cpu")
    codes = _codes(100, key_dtype, 0.3, seed=7)
    _, ops, _, _, new_n = _held_to_plain(dev, tree.keys, codes, tree.n_nodes, 16)
    assert int(ops[0]) == 8 and int(new_n) == 8


@pytest.mark.parametrize("key_dtype", KEYS)
def test_leaf_split_into_4096_that_passes_the_capacity(dev, key_dtype):
    tree = root_tree(key_dtype, 1000, device="cpu")
    codes = _codes(200_000, key_dtype, 0.3, seed=11)
    _, ops, conv, new_keys, new_n = _held_to_plain(dev, tree.keys, codes, tree.n_nodes, 16)
    assert int(ops[0]) == 4096 and not bool(conv)
    assert int(new_n) == 4096 > tree.capacity
    assert int(new_keys[-2]) == 999 * (1 << 3 * (max_tree_level(key_dtype) - 4))


@pytest.mark.parametrize("key_dtype", KEYS)
def test_leaf_split_into_4096_within_the_capacity(dev, key_dtype):
    tree = root_tree(key_dtype, 5000, device="cpu")
    codes = _codes(200_000, key_dtype, 0.3, seed=12)
    _, ops, _, new_keys, new_n = _held_to_plain(dev, tree.keys, codes, tree.n_nodes, 16)
    assert int(ops[0]) == 4096 and int(new_n) == 4096
    assert int(new_keys[4096]) == int(new_keys[-1])


@pytest.mark.parametrize("key_dtype", KEYS)
@pytest.mark.parametrize("as_tensor", [False, True])
def test_n_codes_below_the_key_count(dev, key_dtype, as_tensor):
    tree = uniform_tree(key_dtype, 3, 600, device="cpu")
    codes = _codes(40_000, key_dtype, 0.15, seed=5)
    n_codes = 31_234
    counts, *_ = _held_to_plain(dev, tree.keys, codes, tree.n_nodes, 32,
                                n_codes=torch.tensor(n_codes) if as_tensor else n_codes)
    assert int(counts.sum()) == n_codes


@pytest.mark.parametrize("key_dtype", KEYS)
def test_counts_clipped_by_max_count(dev, key_dtype):
    tree = uniform_tree(key_dtype, 2, 100, device="cpu")
    codes = _codes(30_000, key_dtype, 0.1, seed=9)
    counts, *_ = _held_to_plain(dev, tree.keys, codes, tree.n_nodes, 8, max_count=700)
    assert int(counts.max()) == 700


def _converge(tree, codes, bucket, n_codes=None):
    with trace.collect() as tally:
        out, changed = converge_global_octree(tree, codes, bucket, None, 0xFFFFFFFE, n_codes)
    return out, changed, tally.read()["counts"]


@pytest.mark.parametrize("key_dtype", KEYS)
@pytest.mark.parametrize("start", ["root", "warm"])
def test_converge_global_octree_node_for_node(dev, key_dtype, start):
    _, tree, drifted = _gauss_tree(key_dtype)
    if start == "root":
        tree = root_tree(key_dtype, GAUSS_CAP, device="cpu")
    n_codes = GAUSS_N - 1000
    card = CsArray(keys=tree.keys.to(dev), counts=tree.counts.to(dev), n_nodes=tree.n_nodes.to(dev))
    got, changed, counted = _converge(card, drifted.to(dev), GAUSS_BUCKET, torch.tensor(n_codes, device=dev))
    want, want_changed, want_counted = _converge(tree, drifted, GAUSS_BUCKET, n_codes)
    assert changed == want_changed is True
    for f in ("keys", "counts", "n_nodes"):
        _same(getattr(got, f), getattr(want, f), f)
    assert counted.get("csarray.plain", 0) == 0 and want_counted.get("csarray.kernel", 0) == 0
    assert counted["csarray.kernel"] == want_counted["csarray.plain"]
    assert counted["tree.rounds"] == want_counted["tree.rounds"]
    rounds = counted["tree.rounds"]
    # the first count and decision, then a count and two decisions and an emission a round
    assert counted["csarray.kernel"] == 2 + 4 * rounds
    if start == "warm":
        assert rounds >= 1
