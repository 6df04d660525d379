"""mark_macs's walk on the card: the kernel of csrc/mark_macs.cu (one
depth-first launch) against the plain walk (traversal.macs.mark_walk_plain,
breadth first) run on the same card on the same prepared arrays, bit for
bit, and exactly one launch a call, counted by the wrapper and by the
trace counter `macs.kernel` (`macs.plain` never).

Cases: the four rank focus trees of the benchmark's 4-card configuration
(benchmark/configs/uniform-4x2M-h012.json: 8M uniform particles from
sample_seed 42, bucket 64, theta 0.5), converged on one card from the
sorted pool, in their periodic box and in an open one, limit_source both
ways; tests/deep_tree.py's tree, whose walks keep more than 128 pushes
pending, also held to a brute-force reference; no active target (the
focus is the whole domain, or n_focus is 0) and every target active (an
empty focus). Skips without an NVIDIA GPU and nvcc; chip_smoke.py's phase
8 runs the same check on its rank. Tolerance: marks exact."""

import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

from cstone_tpu_torch.domain.decomposition import make_sfc_assignment
from cstone_tpu_torch.focus.octree_focus import focus_converge
from cstone_tpu_torch.focus.source_center import geo_mac_spheres
from cstone_tpu_torch.ops import mark_macs as kernel
from cstone_tpu_torch.ops.cuda_lib import nvcc_path
from cstone_tpu_torch.ops.keys64 import usort
from cstone_tpu_torch.sfc import PERIODIC, compute_sfc_keys, make_box
from cstone_tpu_torch.traversal import macs
from cstone_tpu_torch.tree import compute_octree, root_tree
from cstone_tpu_torch.utils import trace

from deep_tree import all_pairs, deep_sample, deep_tree, passes_to_root

pytestmark = pytest.mark.cuda

CONFIG = pathlib.Path(__file__).resolve().parent.parent / "benchmark" / "configs" / "uniform-4x2M-h012.json"


@pytest.fixture(scope="module")
def cuda_device():
    try:
        nvcc_path()
    except RuntimeError:
        pytest.skip("needs an NVIDIA GPU and nvcc")
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


def _to(linked, dev):
    return dataclasses.replace(linked, **{f.name: getattr(linked, f.name).to(dev)
                                          for f in dataclasses.fields(linked)})


def _kernel_marks(linked, centers, box, fs, fe, leaves, n_focus, limit_source):
    """mark_macs on the card under a trace, checked to launch the kernel
    exactly once and run no plain walk."""
    before = kernel.launches()["mark_walk"]
    with trace.collect() as tally:
        marks = macs.mark_macs(linked, centers, box, fs, fe, leaves, n_focus, limit_source)
    torch.cuda.synchronize()
    assert kernel.launches()["mark_walk"] == before + 1
    # the prepare step's codec calls: the targets' decode, contained_in_keys' two encodes
    assert tally.read()["counts"] == {"macs.kernel": 1, "sfc.kernel": 3}
    return marks


def _plain_marks(linked, centers, box, fs, fe, leaves, n_focus, limit_source):
    inputs = macs.prepare_marks(linked, centers, box, fs, fe, leaves, n_focus, limit_source)
    return macs.mark_walk_plain(inputs, linked.child_offsets, box), inputs


@pytest.fixture(scope="module")
def rank_trees(cuda_device):
    """Each rank's converged focus tree of the 4-card configuration, and
    the focus ranges, built on one card."""
    from benchmark.sample import draw

    cfg = json.loads(CONFIG.read_text())
    dev = cuda_device
    (x, y, z), _, _ = draw(cfg, 0, dev, 0.0)
    box = make_box(0.0, 1.0, boundaries=PERIODIC, device=dev)
    keys, _ = usort(compute_sfc_keys(x, y, z, box, np.uint64))
    cap = cfg["tree_capacity"]
    gtree = compute_octree(keys, cfg["bucket"], capacity=cap)
    bnd = make_sfc_assignment(gtree.keys, gtree.counts, gtree.n_nodes, cfg["ranks"]).boundaries
    inv_theta = macs.inv_theta_min_mac(cfg["theta"])
    trees = []
    for r in range(cfg["ranks"]):
        leaves, n_leaf, linked, _, overflow, _, converged = focus_converge(
            root_tree(np.uint64, cap, device=dev).keys, 1, keys, cfg["n"], box, bnd[r], bnd[r + 1], bnd,
            cfg["bucket_focus"], inv_theta, skip_macs=False)
        assert converged and int(overflow) == 0
        trees.append((linked, bnd[r], bnd[r + 1]))
    return trees, inv_theta


@pytest.mark.parametrize("limit_source", [True, False])
@pytest.mark.parametrize("periodic", [True, False])
def test_kernel_equals_plain_walk_on_the_4card_rank_trees(rank_trees, periodic, limit_source):
    trees, inv_theta = rank_trees
    for linked, fs, fe in trees:
        dev = linked.prefixes.device
        box = make_box(0.0, 1.0, boundaries=PERIODIC if periodic else 0, device=dev)
        centers = geo_mac_spheres(linked, inv_theta, box)
        args = (linked, centers, box, fs, fe, linked.leaves, linked.n_leaf, limit_source)
        got = _kernel_marks(*args)
        want, inputs = _plain_marks(*args)
        assert torch.equal(got, want)
        assert 0 < int(want.sum()) < int(linked.n_nodes)
        assert 0 < int(inputs.active.sum()) < int(linked.n_leaf)


def test_kernel_marks_nothing_without_an_active_target_and_all_targets_walk_on_an_empty_focus(rank_trees):
    trees, inv_theta = rank_trees
    linked, fs, fe = trees[1]
    dev = linked.prefixes.device
    box = make_box(0.0, 1.0, boundaries=PERIODIC, device=dev)
    centers = geo_mac_spheres(linked, inv_theta, box)
    whole = (linked.leaves[0], linked.leaves[linked.n_leaf])
    for focus, n_focus in ((whole, linked.n_leaf), ((fs, fe), torch.zeros_like(linked.n_leaf))):
        args = (linked, centers, box, *focus, linked.leaves, n_focus, True)
        got = _kernel_marks(*args)
        want, inputs = _plain_marks(*args)
        assert not bool(inputs.active.any())
        assert int(got.sum()) == 0 and torch.equal(got, want)
    # an empty focus: no target lies inside it, and every node is outside it
    args = (linked, centers, box, fs, fs, linked.leaves, linked.n_leaf, True)
    got = _kernel_marks(*args)
    want, inputs = _plain_marks(*args)
    assert int(inputs.active.sum()) == int(linked.n_leaf)
    assert torch.equal(got, want) and int(got.sum()) > 0


@pytest.mark.parametrize("limit_source", [True, False])
@pytest.mark.parametrize("theta", [0.5, 1e-3])
def test_kernel_on_the_deep_tree_equals_plain_walk_and_brute_force(cuda_device, theta, limit_source):
    _, box, _, linked = deep_tree(deep_sample(20), capacity=2560)
    n_leaf = int(linked.n_leaf)
    leaves = linked.leaves[:n_leaf + 1]
    fs, fe = leaves[0], leaves[3]
    centers = geo_mac_spheres(linked, macs.inv_theta_min_mac(theta), box)
    inputs = macs.prepare_marks(linked, centers, box, fs, fe, leaves, n_leaf, limit_source)
    q, node = all_pairs(n_leaf, linked.child_offsets.shape[0])
    crit = macs.evaluate_mac(inputs.src_center[node], inputs.mac_sq[node], inputs.t_center[q], inputs.t_size[q], box)
    crit = crit & inputs.outside[node] & (inputs.node_level[node] <= inputs.max_level[q]) & inputs.active[q]
    brute = passes_to_root(linked, crit.reshape(n_leaf, -1)).any(0)

    dev = cuda_device
    dl, dbox = _to(linked, dev), make_box(0.0, 1.0, device=dev)
    args = (dl, centers.to(dev), dbox, fs.to(dev), fe.to(dev), leaves.to(dev), n_leaf, limit_source)
    got = _kernel_marks(*args)
    want, _ = _plain_marks(*args)
    assert torch.equal(got, want)
    assert torch.equal(got.cpu().bool(), brute)
    assert int(inputs.node_level[brute].max()) >= 20
