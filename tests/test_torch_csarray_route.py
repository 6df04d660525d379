"""The route of tree/csarray's fixed-point functions on the CPU: CPU keys
take the plain torch functions and count `csarray.plain`, without building
or loading csrc/csarray.cu; the kernels' wrapper (ops/csarray.py) refuses
CPU tensors, the dtypes its kernels do not take and an n_nodes that is not
a 0-d int64 tensor before it loads anything. Builds and launches nothing,
so it runs on the CPU; tests/test_torch_csarray_cuda.py holds the kernels
to the plain functions on the card."""

import numpy as np
import pytest
import torch

from cstone_tpu_torch.ops import csarray as kernels
from cstone_tpu_torch.tree.csarray import (compute_node_counts, compute_node_counts_plain, rebalance_decision,
                                           rebalance_decision_plain, rebalance_tree, rebalance_tree_plain,
                                           uniform_tree)
from cstone_tpu_torch.utils import trace

import torch_threads  # noqa: F401  (two intra-op threads per xdist worker)


@pytest.fixture
def no_library(monkeypatch):
    """Fail the test if anything builds or loads csrc/csarray.cu."""
    def refuse():
        raise AssertionError("csrc/csarray.cu was built or loaded")
    monkeypatch.setattr(kernels.LIBRARY, "load", refuse)


def _tree_and_codes(key_dtype):
    """A level-2 uniform tree padded past its leaves, and sorted keys
    clustered in its first octant, so that the decision splits and merges."""
    tree = uniform_tree(key_dtype, 2, 90, device="cpu")
    end = 1 << (30 if key_dtype == np.uint32 else 63)
    rng = np.random.default_rng(3)
    codes = np.sort(rng.integers(0, end // 64, 3000, dtype=np.uint64)).astype(key_dtype)
    codes = torch.from_numpy(codes.view(np.int32 if key_dtype == np.uint32 else np.int64).copy())
    return tree, codes


@pytest.mark.parametrize("key_dtype", [np.uint32, np.uint64])
def test_cpu_keys_take_the_plain_functions(no_library, key_dtype):
    tree, codes = _tree_and_codes(key_dtype)
    before = kernels.launches()
    with trace.collect() as tally:
        counts = compute_node_counts(tree.keys, codes, 0xFFFFFFFF, 2500)
        ops, conv = rebalance_decision(tree.keys, counts, tree.n_nodes, 16)
        new_keys, new_n = rebalance_tree(tree.keys, ops, tree.n_nodes)
    assert tally.read()["counts"] == {"csarray.plain": 3}
    assert kernels.launches() == before

    want_counts = compute_node_counts_plain(tree.keys, codes, 0xFFFFFFFF, 2500)
    want_ops, want_conv = rebalance_decision_plain(tree.keys, want_counts, tree.n_nodes, 16)
    want_keys, want_n = rebalance_tree_plain(tree.keys, want_ops, tree.n_nodes)
    for got, want in ((counts, want_counts), (ops, want_ops), (conv, want_conv), (new_keys, want_keys),
                      (new_n, want_n)):
        assert got.dtype == want.dtype and torch.equal(got, want)
    assert int(counts.sum()) == 2500 and not bool(conv)
    assert bool((ops == 0).any()) and bool((ops >= 8).any())


@pytest.mark.parametrize("key_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("call", ["counts", "decide", "emit"])
def test_wrapper_refuses_cpu_tensors(no_library, key_dtype, call):
    keys = torch.zeros(9, dtype=key_dtype)
    with pytest.raises(ValueError, match="CUDA"):
        if call == "counts":
            kernels.node_counts(keys, torch.zeros(4, dtype=key_dtype), 10)
        elif call == "decide":
            kernels.decide(keys, torch.zeros(8, dtype=torch.int64), torch.tensor(1), 8)
        else:
            kernels.emit(keys, torch.ones(8, dtype=torch.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.int16, torch.uint8, torch.bool])
@pytest.mark.parametrize("call", ["counts", "decide", "emit"])
def test_wrapper_refuses_unsupported_key_dtypes(no_library, dtype, call):
    keys = torch.zeros(9, dtype=dtype)
    with pytest.raises(TypeError, match="int32 or int64 keys"):
        if call == "counts":
            kernels.node_counts(keys, torch.zeros(4, dtype=dtype), 10)
        elif call == "decide":
            kernels.decide(keys, torch.zeros(8, dtype=torch.int64), torch.tensor(1), 8)
        else:
            kernels.emit(keys, torch.ones(8, dtype=torch.int32))


@pytest.mark.parametrize("n_nodes", [1, torch.tensor(1, dtype=torch.int32), torch.tensor([1]), torch.tensor(1.0)])
def test_wrapper_refuses_n_nodes_that_is_not_a_0d_int64_tensor(no_library, n_nodes):
    with pytest.raises(TypeError, match="n_nodes"):
        kernels.decide(torch.zeros(9, dtype=torch.int64), torch.zeros(8, dtype=torch.int64), n_nodes, 8)


@pytest.mark.parametrize("what", ["codes", "counts", "ops"])
def test_wrapper_refuses_other_operand_dtypes(no_library, what):
    keys = torch.zeros(9, dtype=torch.int64)
    with pytest.raises(TypeError, match=what):
        if what == "codes":
            kernels.node_counts(keys, torch.zeros(4, dtype=torch.int32), 10)
        elif what == "counts":
            kernels.decide(keys, torch.zeros(8, dtype=torch.int32), torch.tensor(1), 8)
        else:
            kernels.emit(keys, torch.ones(8, dtype=torch.int64))
