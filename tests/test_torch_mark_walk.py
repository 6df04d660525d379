"""mark_macs split into its prepare step and its walk: the prepared arrays
plus the plain walk (the path CPU tensors take) against the JAX package's
mark_macs, and against brute force on a tree deeper than the JAX walk's
stack. The CUDA kernel that CUDA tensors take is held to the same plain
walk on the card in test_torch_macs_cuda.py.

The focus trees: rank 1 of 4 of a uniform sample (4,000 particles in the
periodic unit cube, bucket 16), converged by the port's focus_converge
from the sorted pool, so the leaves outside the rank's range are targets
too; 32- and 64-bit Hilbert keys; marked in a periodic and an open box,
limit_source both ways. The deep tree is tests/deep_tree.py's (nodes
at level 20, more pending pushes than the JAX walk's 128-entry stack
holds), with the focus on its first leaves, so the walks descend the
whole deep path. Tolerance: marks exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cstone_tpu.focus.source_center import geo_mac_spheres as jax_geo_mac_spheres
from cstone_tpu.sfc import PERIODIC
from cstone_tpu.sfc import make_box as jax_make_box
from cstone_tpu.traversal import macs as jmacs
from cstone_tpu.tree.octree import build_linked_octree as jax_build_linked_octree
from cstone_tpu_torch.domain.decomposition import make_sfc_assignment
from cstone_tpu_torch.focus.octree_focus import focus_converge
from cstone_tpu_torch.focus.source_center import geo_mac_spheres
from cstone_tpu_torch.interop import from_numpy_tree
from cstone_tpu_torch.ops import mark_macs as kernel
from cstone_tpu_torch.ops.keys64 import to_numpy, usort
from cstone_tpu_torch.sfc import compute_sfc_keys, make_box
from cstone_tpu_torch.traversal import macs
from cstone_tpu_torch.tree import compute_octree, root_tree
from cstone_tpu_torch.utils import trace

import torch_threads  # noqa: F401  (two intra-op threads per xdist worker)
from deep_tree import all_pairs, deep_sample, deep_tree, passes_to_root

N, BUCKET, RANKS, RANK = 4000, 16, 4, 1
INV_THETA = macs.inv_theta_min_mac(0.5)


@pytest.fixture(scope="module", params=[np.uint32, np.uint64], ids=["u32", "u64"])
def rank_tree(request):
    """(key dtype, JAX linked tree, the port's copy of it, focus start and
    end as key tensors) of rank RANK's converged focus tree."""
    kdt = request.param
    rng = np.random.RandomState(11)
    pos = torch.from_numpy(rng.uniform(0.0, 1.0, (3, N)).astype(np.float32))
    box = make_box(0.0, 1.0, boundaries=PERIODIC, device="cpu")
    keys, _ = usort(compute_sfc_keys(pos[0], pos[1], pos[2], box, kdt))
    gtree = compute_octree(keys, 64, capacity=1024)
    bnd = make_sfc_assignment(gtree.keys, gtree.counts, gtree.n_nodes, RANKS).boundaries
    fs, fe = bnd[RANK], bnd[RANK + 1]
    leaves, n_leaf, *_, converged = focus_converge(root_tree(kdt, 1024, device="cpu").keys, 1, keys, N, box, fs, fe,
                                                   bnd, BUCKET, INV_THETA, skip_macs=False)
    assert converged
    n_leaf = int(n_leaf)
    jl = jax_build_linked_octree(jnp.asarray(to_numpy(leaves)), n_leaf)
    return kdt, jl, from_numpy_tree(jl, device="cpu"), fs, fe


@pytest.mark.parametrize("limit_source", [True, False])
@pytest.mark.parametrize("periodic", [True, False])
def test_prepare_and_plain_walk_match_jax_on_a_rank_focus_tree(rank_tree, periodic, limit_source):
    kdt, jl, tl, fs, fe = rank_tree
    b = PERIODIC if periodic else 0
    jbox, tbox = jax_make_box(0.0, 1.0, boundaries=b), make_box(0.0, 1.0, boundaries=b, device="cpu")
    jc = jax_geo_mac_spheres(jl, INV_THETA, jbox)
    want = np.asarray(jmacs.mark_macs(jl, jc, jbox, to_numpy(fs)[()], to_numpy(fe)[()], jl.leaves, jl.n_leaf,
                                      limit_source))
    inputs = macs.prepare_marks(tl, geo_mac_spheres(tl, INV_THETA, tbox), tbox, fs, fe, tl.leaves, tl.n_leaf,
                                limit_source)
    got = macs.mark_walk_plain(inputs, tl.child_offsets, tbox)
    np.testing.assert_array_equal(got.numpy(), want)
    n_nodes = int(jl.n_nodes)
    assert 0 < want.sum() < n_nodes
    # foreign leaves are targets: most targets walk, the interior ones do not
    n_active = int(inputs.active.sum())
    assert 0 < n_active < int(tl.n_leaf)
    assert torch.equal(macs.mark_macs(tl, geo_mac_spheres(tl, INV_THETA, tbox), tbox, fs, fe, tl.leaves, tl.n_leaf,
                                      limit_source), got)


@pytest.fixture(scope="module")
def deep():
    pos, box, tree, linked = deep_tree(deep_sample(20), capacity=2560)
    return box, linked


@pytest.mark.parametrize("limit_source", [True, False])
@pytest.mark.parametrize("theta", [0.5, 1e-3])
def test_plain_walk_on_the_deep_tree_matches_brute_force(deep, theta, limit_source):
    box, linked = deep
    n_leaf = int(linked.n_leaf)
    leaves = linked.leaves[:n_leaf + 1]  # the targets: every leaf of the tree
    fs, fe = leaves[0], leaves[3]
    centers = geo_mac_spheres(linked, macs.inv_theta_min_mac(theta), box)
    inputs = macs.prepare_marks(linked, centers, box, fs, fe, leaves, n_leaf, limit_source)
    got = macs.mark_walk_plain(inputs, linked.child_offsets, box)

    n_q, cap_nodes = n_leaf, linked.child_offsets.shape[0]
    q, node = all_pairs(n_q, cap_nodes)
    crit = macs.evaluate_mac(inputs.src_center[node], inputs.mac_sq[node], inputs.t_center[q], inputs.t_size[q], box)
    crit = crit & inputs.outside[node] & (inputs.node_level[node] <= inputs.max_level[q]) & inputs.active[q]
    want = passes_to_root(linked, crit.reshape(n_q, cap_nodes)).any(0)
    assert torch.equal(got.bool(), want)
    # the walks reach the bottom of the deep path
    assert int(inputs.node_level[got.bool()].max()) >= 20


def test_mark_macs_on_cpu_tensors_counts_one_plain_walk_and_no_launch(rank_tree):
    _, _, tl, fs, fe = rank_tree
    box = make_box(0.0, 1.0, boundaries=PERIODIC, device="cpu")
    centers = geo_mac_spheres(tl, INV_THETA, box)
    with trace.collect() as tally:
        macs.mark_macs(tl, centers, box, fs, fe, tl.leaves, tl.n_leaf, limit_source=True)
    out = tally.read()
    # the prepare step's codec calls: the targets' decode, contained_in_keys' two encodes
    assert out["counts"] == {"macs.plain": 1, "sfc.plain": 3}
    assert out["spans"]["macs.mark"]["calls"] == 1
    # the kernel's wrapper takes CUDA tensors only
    inputs = macs.prepare_marks(tl, centers, box, fs, fe, tl.leaves, tl.n_leaf, True)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.mark_walk(*inputs, tl.child_offsets, box, 21)
    assert kernel.launches() == {"mark_walk": 0}
