"""The linked-octree build on the card: the kernels of csrc/octree.cu (a
`layout` and a `link` launch around one sort, through
tree/octree.build_linked_octree's dispatch) against the plain build run on
the same card on the same leaves, and against the plain build on the CPU,
in all nine LinkedOctree fields over the whole capacity, padding included,
for uint32 and uint64 keys; one launch of each kernel a build, counted by
the wrapper and by the trace counter `octree.kernel` (`octree.plain`
never), and no host read inside the build (torch.cuda.set_sync_debug_mode
"error").

Cases: uniform trees at levels 1-5 (padded past their leaves), the deep
tree of a 200k Gaussian sample (sigma 0.01, bucket 8: levels to 10 with
uint32 keys, 11 with uint64), the root-only tree (n_leaf 1), a tree that
fills its capacity (n_leaf = cap_leaf), an explicit cap_nodes, and n_leaf
as an int and as a 0-d tensor. Skips without an NVIDIA GPU and nvcc;
chip_smoke.py's phase 19 runs the build at the benchmark cells' shapes.
Tolerance: every field exact."""

import functools

import numpy as np
import pytest
import torch

from cstone_tpu_torch.ops import linked_octree
from cstone_tpu_torch.ops.cuda_lib import nvcc_path
from cstone_tpu_torch.ops.keys64 import from_numpy, usort
from cstone_tpu_torch.sfc import compute_sfc_keys, make_box
from cstone_tpu_torch.sfc.keys import max_tree_level
from cstone_tpu_torch.tree.csarray import compute_octree
from cstone_tpu_torch.tree.octree import _build_plain, build_linked_octree, internal_capacity
from cstone_tpu_torch.utils import trace

pytestmark = pytest.mark.cuda

KEYS = [np.uint32, np.uint64]
FIELDS = ("prefixes", "child_offsets", "parents", "level_range", "internal_to_leaf", "leaf_to_internal", "leaves",
          "n_leaf", "n_internal")


@pytest.fixture(scope="module")
def dev():
    try:
        nvcc_path()
    except RuntimeError:
        pytest.skip("needs an NVIDIA GPU and nvcc")
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


def _end(key_dtype) -> int:
    return 1 << 3 * max_tree_level(key_dtype)


def _padded(leaves: np.ndarray, cap_leaf: int, key_dtype) -> np.ndarray:
    out = np.full(cap_leaf + 1, _end(key_dtype), dtype=key_dtype)
    out[:leaves.shape[0]] = leaves
    return out


def _uniform(level: int, key_dtype, pad: int) -> tuple:
    n = 8 ** level
    leaves = (np.arange(n + 1, dtype=np.uint64) * np.uint64(_end(key_dtype) // n)).astype(key_dtype)
    return from_numpy(_padded(leaves, n + pad, key_dtype)), n


@functools.cache
def _gauss(key_dtype) -> tuple:
    rng = np.random.default_rng(5)
    pos = torch.from_numpy(np.clip(rng.normal(0.5, 0.01, (200_000, 3)), 0, 1 - 1e-7).astype(np.float32))
    box = make_box(0.0, 1.0, device="cpu")
    keys, _ = usort(compute_sfc_keys(pos[:, 0], pos[:, 1], pos[:, 2], box, key_dtype))
    tree = compute_octree(keys, 8, capacity=131072)
    return tree.keys, tree.n_nodes


def _same(got, want, what):
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, (what, f, a.dtype, b.dtype, a.shape, b.shape)
        assert torch.equal(a.cpu(), b.cpu()), (what, f, int((a.cpu() != b.cpu()).sum()))


def _held_to_plain(dev, leaves_cpu, n_leaf, cap_nodes=None, as_tensor=True):
    """The kernel route on the card against the plain build on the card and
    on the CPU; one layout and one link launch, `octree.kernel` once, no
    host read inside the build."""
    leaves = leaves_cpu.to(dev)
    n_arg = torch.tensor(int(n_leaf), dtype=torch.int64, device=dev) if as_tensor else int(n_leaf)
    torch.cuda.synchronize()
    before = linked_octree.launches()
    with trace.collect() as tally:
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = build_linked_octree(leaves, n_arg, cap_nodes)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    after = linked_octree.launches()
    assert {k: after[k] - before[k] for k in after} == {"layout": 1, "link": 1}
    assert tally.read()["counts"] == {"octree.kernel": 1}
    assert got.leaves is leaves

    cap_leaf = leaves_cpu.shape[0] - 1
    cap = cap_leaf + internal_capacity(cap_leaf) if cap_nodes is None else cap_nodes
    cap_parents = max(1, (cap - 1) // 8 + 1)
    _same(got, _build_plain(leaves, int(n_leaf), cap, cap_parents), "plain on the card")
    with trace.collect() as tally:
        on_cpu = build_linked_octree(leaves_cpu, int(n_leaf), cap_nodes)
    assert tally.read()["counts"] == {"octree.plain": 1}
    _same(got, on_cpu, "plain on the CPU")
    return got


@pytest.mark.parametrize("key_dtype", KEYS)
@pytest.mark.parametrize("level", [1, 2, 3, 4, 5])
def test_uniform_levels(dev, key_dtype, level):
    leaves, n = _uniform(level, key_dtype, pad=57)
    got = _held_to_plain(dev, leaves, n)
    assert int(got.n_nodes) == n + (n - 1) // 7
    assert got.level_range[level].item() == (n - 1) // 7


@pytest.mark.parametrize("key_dtype", KEYS)
def test_deep_gaussian_tree(dev, key_dtype):
    leaves, n_leaf = _gauss(key_dtype)
    got = _held_to_plain(dev, leaves, n_leaf)
    deepest = 10 if key_dtype == np.uint32 else 11
    assert got.level_range[deepest].item() < got.level_range[deepest + 1].item()


@pytest.mark.parametrize("key_dtype", KEYS)
def test_root_only(dev, key_dtype):
    leaves = from_numpy(_padded(np.array([0, _end(key_dtype)], dtype=key_dtype), 9, key_dtype))
    got = _held_to_plain(dev, leaves, 1)
    assert int(got.n_nodes) == 1 and int(got.n_internal) == 0


@pytest.mark.parametrize("key_dtype", KEYS)
def test_tree_that_fills_its_capacity(dev, key_dtype):
    leaves, n = _uniform(3, key_dtype, pad=0)
    assert leaves.shape[0] == n + 1
    _held_to_plain(dev, leaves, n)


@pytest.mark.parametrize("key_dtype", KEYS)
@pytest.mark.parametrize("extra", [0, 5, 300])
def test_explicit_cap_nodes(dev, key_dtype, extra):
    leaves, n_leaf = _gauss(key_dtype)
    n = int(n_leaf)
    _held_to_plain(dev, leaves, n_leaf, cap_nodes=n + (n - 1) // 7 + extra)


@pytest.mark.parametrize("key_dtype", KEYS)
@pytest.mark.parametrize("as_tensor", [False, True])
def test_n_leaf_as_int_or_tensor(dev, key_dtype, as_tensor):
    leaves, n = _uniform(2, key_dtype, pad=100)
    got = _held_to_plain(dev, leaves, n, as_tensor=as_tensor)
    assert got.n_leaf.device == leaves.to(dev).device and got.n_leaf.dim() == 0


def test_oversized_cap_nodes_raises(dev):
    leaves = from_numpy(np.array([0, 2**63, 2**63], dtype=np.uint64)).to(dev)
    with pytest.raises(ValueError, match="cap_nodes"):
        build_linked_octree(leaves, 1, cap_nodes=5)
