"""The route of tree/octree.build_linked_octree on the CPU: CPU leaves take
the plain torch build and count `octree.plain`, without building or
loading csrc/octree.cu; the kernels' wrapper (ops/linked_octree.build)
refuses CPU tensors and the dtypes its kernels do not take before it
loads anything. Builds and launches nothing, so it runs on the CPU;
tests/test_torch_octree_cuda.py holds the kernels to the plain build on
the card."""

import numpy as np
import pytest
import torch

from cstone_tpu_torch.ops import linked_octree
from cstone_tpu_torch.ops.keys64 import from_numpy
from cstone_tpu_torch.tree.octree import _build_plain, build_linked_octree, internal_capacity
from cstone_tpu_torch.utils import trace

import torch_threads  # noqa: F401  (two intra-op threads per xdist worker)

FIELDS = ("prefixes", "child_offsets", "parents", "level_range", "internal_to_leaf", "leaf_to_internal", "leaves",
          "n_leaf", "n_internal")


@pytest.fixture
def no_library(monkeypatch):
    """Fail the test if anything builds or loads csrc/octree.cu."""
    def refuse():
        raise AssertionError("csrc/octree.cu was built or loaded")
    monkeypatch.setattr(linked_octree.LIBRARY, "load", refuse)


def _uniform(level: int, key_dtype, pad: int):
    end = 1 << (30 if key_dtype == np.uint32 else 63)
    n = 8 ** level
    leaves = np.full(n + pad + 1, end, dtype=key_dtype)
    leaves[:n + 1] = (np.arange(n + 1, dtype=np.uint64) * np.uint64(end // n)).astype(key_dtype)
    return from_numpy(leaves), n


@pytest.mark.parametrize("key_dtype", [np.uint32, np.uint64])
@pytest.mark.parametrize("n_leaf_kind", ["int", "tensor"])
def test_cpu_leaves_take_the_plain_build(no_library, key_dtype, n_leaf_kind):
    leaves, n = _uniform(2, key_dtype, pad=30)
    n_leaf = n if n_leaf_kind == "int" else torch.tensor(n)
    before = linked_octree.launches()
    with trace.collect() as tally:
        got = build_linked_octree(leaves, n_leaf)
    assert tally.read()["counts"] == {"octree.plain": 1}
    assert linked_octree.launches() == before
    cap_leaf = leaves.shape[0] - 1
    cap_nodes = cap_leaf + internal_capacity(cap_leaf)
    want = _build_plain(leaves, n, cap_nodes, (cap_nodes - 1) // 8 + 1)
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert int(got.n_nodes) == n + (n - 1) // 7


@pytest.mark.parametrize("key_dtype", [torch.int32, torch.int64])
def test_wrapper_refuses_cpu_tensors(no_library, key_dtype):
    leaves = torch.zeros(9, dtype=key_dtype)
    with pytest.raises(ValueError, match="CUDA"):
        linked_octree.build(leaves, torch.tensor(1), 10, 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.int16, torch.uint8, torch.bool])
def test_wrapper_refuses_unsupported_key_dtypes(no_library, dtype):
    with pytest.raises(TypeError, match="int32 or int64 keys"):
        linked_octree.build(torch.zeros(9, dtype=dtype), torch.tensor(1), 10, 2)


@pytest.mark.parametrize("n_leaf", [1, torch.tensor(1, dtype=torch.int32), torch.tensor([1]), torch.tensor(1.0)])
def test_wrapper_refuses_n_leaf_that_is_not_a_0d_int64_tensor(no_library, n_leaf):
    with pytest.raises(TypeError, match="n_leaf"):
        linked_octree.build(torch.zeros(9, dtype=torch.int64), n_leaf, 10, 2)
