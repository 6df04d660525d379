"""The port's tree walks on a tree deeper than the JAX walks' 128-entry
stack: batched_mark, batched_collect_leaves and the monopole walk of
gravity_monopole, held against brute-force references; and equal to
the JAX walks where the JAX stack holds.

The tree: tests/deep_tree.py's, the node path to the largest key and
at each level on it the 7 other children, each holding one pair of
points (bucket 1); a depth-first walk that descends the path keeps more
than 128 pushes pending, where the JAX walks drop them.

Tolerance: marks, leaf sets and counts exact; accelerations within 1e-4
of |a| of a float64 Barnes-Hut sum over the same accepted nodes and P2P
leaves (brute force) and of JAX's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cstone_tpu.traversal.traversal import batched_collect_leaves as jax_collect
from cstone_tpu.traversal.traversal import batched_mark as jax_mark
from cstone_tpu_torch.domain.layout import leaf_layout_from_counts
from cstone_tpu_torch.focus.source_center import compute_leaf_source_centers, set_mac_radii, upsweep_centers
from cstone_tpu_torch.models.nbody import gravity_monopole
from cstone_tpu_torch.traversal.boxoverlap import min_distance_boxes, min_distance_point_box
from cstone_tpu_torch.traversal.geometry import node_geometry
from cstone_tpu_torch.traversal.traversal import batched_collect_leaves, batched_mark

import torch_threads  # noqa: F401  (two intra-op threads per xdist worker)
from deep_tree import all_pairs, deep_sample, deep_tree, passes_to_root


@pytest.fixture(scope="module")
def deep():
    pos, box, tree, linked = deep_tree(deep_sample(20))
    centers, sizes = node_geometry(linked, box)
    return pos, box, tree, linked, centers, sizes


@pytest.fixture(scope="module")
def shallow():
    pos, box, tree, linked = deep_tree(deep_sample(12))
    centers, sizes = node_geometry(linked, box)
    return pos, box, tree, linked, centers, sizes


def _query_crit(centers, sizes, n_q, radius, seed):
    """Box queries around points near the largest key's corner (and one
    covering the whole box): (port criterion, JAX criterion)."""
    rng = np.random.RandomState(seed)
    qc = (1.0 - 10.0 ** -rng.uniform(1, 6, size=(n_q, 3))).astype(np.float32)
    qc[0] = 0.5
    qs = np.zeros((n_q, 3), np.float32)
    r = np.float32(radius)
    tqc, tqs = torch.from_numpy(qc), torch.from_numpy(qs)

    def tcrit(q, nid):
        d = min_distance_boxes(tqc[q], tqs[q], centers[nid], sizes[nid])
        return (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2] < r * r) | (q == 0)

    jc, js = jnp.asarray(centers.numpy()), jnp.asarray(sizes.numpy())

    def jcrit(q, nid):
        d = jnp.maximum(jnp.abs(jc[nid] - jnp.asarray(qc)[q]) - js[nid], 0.0)
        return (jnp.sum(d * d, axis=-1) < r * r) | (q == 0)

    return tcrit, jcrit


def test_deep_tree_is_past_the_jax_stack(deep):
    _, _, tree, linked, centers, sizes = deep
    levels = (torch.div(torch.log2(sizes[:int(linked.n_nodes), 0].double()), 1, rounding_mode="floor"))
    assert int(-levels.min()) >= 20  # nodes at level 20 and below
    # the JAX walk of a query that passes everywhere marks fewer nodes than exist
    co = jnp.asarray(linked.child_offsets.numpy().astype(np.int32))
    marks = jax_mark(co, lambda q, n: jnp.ones(q.shape, bool), 1, mark_endpoints_only=False)
    assert int(np.asarray(marks).sum()) < int(linked.n_nodes)


@pytest.mark.parametrize("endpoints", [True, False])
def test_batched_mark_on_the_deep_tree_matches_brute_force(deep, endpoints):
    _, _, _, linked, centers, sizes = deep
    n_q, cap_nodes = 9, linked.child_offsets.shape[0]
    tcrit, _ = _query_crit(centers, sizes, n_q, 3e-4, 1)
    reach = passes_to_root(linked, tcrit(*all_pairs(n_q, cap_nodes)).reshape(n_q, cap_nodes))
    leaf = linked.child_offsets == 0
    want = (reach & leaf).any(0) if endpoints else reach.any(0)
    marks = batched_mark(linked.child_offsets, tcrit, n_q, mark_endpoints_only=endpoints)
    assert torch.equal(marks.bool(), want)
    assert int(marks.sum()) == int(linked.n_leaf if endpoints else linked.n_nodes)


def test_collect_leaves_on_the_deep_tree_matches_brute_force(deep):
    _, _, _, linked, centers, sizes = deep
    n_q, cap_nodes = 9, linked.child_offsets.shape[0]
    tcrit, _ = _query_crit(centers, sizes, n_q, 3e-4, 2)
    reach = passes_to_root(linked, tcrit(*all_pairs(n_q, cap_nodes)).reshape(n_q, cap_nodes))
    want = reach & (linked.child_offsets == 0)
    leaves, counts = batched_collect_leaves(linked.child_offsets, tcrit, n_q, cap_nodes)
    assert torch.equal(counts, want.sum(1))
    assert int(counts[0]) == int(linked.n_leaf) and int(counts[1:].min()) > 0
    for q in range(n_q):
        assert set(leaves[q, :int(counts[q])].tolist()) == set(torch.nonzero(want[q])[:, 0].tolist())


def test_walks_match_jax_where_its_stack_holds(shallow):
    _, _, _, linked, centers, sizes = shallow
    n_q = 9
    tcrit, jcrit = _query_crit(centers, sizes, n_q, 3e-4, 3)
    co = linked.child_offsets
    jco = jnp.asarray(co.numpy().astype(np.int32))
    for endpoints in (True, False):
        np.testing.assert_array_equal(batched_mark(co, tcrit, n_q, endpoints).numpy(),
                                      np.asarray(jax_mark(jco, jcrit, n_q, endpoints)))
    tl, tn = batched_collect_leaves(co, tcrit, n_q, 4096)
    jl, jn = jax_collect(jco, jcrit, n_q, 4096)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    assert int(tn[0]) == int(linked.n_leaf)
    for q in range(n_q):
        assert set(tl[q, :int(tn[q])].tolist()) == set(np.asarray(jl)[q, :int(jn[q])].tolist())


def _bh_brute(pos, m, linked, layout, centers, mac_sq, box, group_size):
    """float64 Barnes-Hut sums over the accepted nodes (passing the MAC
    below ancestors that all fail it; a passing root) and the particles
    of the leaves failing it along their whole path."""
    n = pos.shape[0]
    n_groups = -(-n // group_size)
    cap_nodes = linked.child_offsets.shape[0]
    gpos = torch.cat([pos, torch.zeros(n_groups * group_size - n, 3)]).reshape(n_groups, group_size, 3)
    valid = (torch.arange(n_groups * group_size) < n).reshape(n_groups, group_size)
    big = float(np.finfo(np.float32).max)
    gmin = torch.where(valid[..., None], gpos, big).amin(1)
    gmax = torch.where(valid[..., None], gpos, -big).amax(1)
    gc, gs = (gmin + gmax) * 0.5, (gmax - gmin) * 0.5
    q, node = all_pairs(n_groups, cap_nodes)
    d = min_distance_point_box(centers[node, :3], gc[q], gs[q], box)
    fails = ((d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]) < mac_sq[node]).reshape(n_groups,
                                                                                               cap_nodes)
    nn = int(linked.n_nodes)
    reach_fail = passes_to_root(linked, fails)
    co = linked.child_offsets
    parent = torch.zeros(cap_nodes, dtype=torch.int64)
    internal = torch.nonzero((co > 0) & (torch.arange(cap_nodes) < nn))[:, 0]
    for k in range(8):
        parent[co[internal] + k] = internal
    idx = torch.arange(cap_nodes)
    accepted = ~fails & reach_fail[:, parent] & (idx > 0) & (idx < nn)
    accepted[:, 0] = ~fails[:, 0]
    p2p = reach_fail & (co == 0) & (idx < nn)

    P = pos.double().numpy()
    M = m.double().numpy()
    C = centers.double().numpy()
    lay = layout.numpy()
    i2l = linked.internal_to_leaf.numpy()
    acc = np.zeros((n, 3))
    for g in range(n_groups):
        tgt = np.arange(g * group_size, min(n, (g + 1) * group_size))
        src = C[torch.nonzero(accepted[g])[:, 0].numpy()]
        d = src[None, :, :3] - P[tgt, None, :]
        r2 = (d * d).sum(-1) + 1e-8
        acc[tgt] += (np.abs(src[None, :, 3]) * r2 ** -1.5)[..., None].__mul__(d).sum(1)
        parts = np.concatenate([np.arange(lay[i2l[lf]], lay[i2l[lf] + 1])
                                for lf in torch.nonzero(p2p[g])[:, 0].numpy()] + [np.zeros(0, np.int64)])
        d = P[None, parts] - P[tgt, None]
        r2 = (d * d).sum(-1) + 1e-8
        w = np.where(parts[None, :] != tgt[:, None], M[parts][None, :] * r2 ** -1.5, 0.0)
        acc[tgt] += (w[..., None] * d).sum(1)
    return acc


@pytest.mark.parametrize("theta", [0.5, 0.3, 1e-3])
def test_gravity_on_the_deep_tree_matches_brute_force(deep, theta):
    """At theta 0.3 and 1e-3 the JAX walks drop visits on this tree, and
    their accelerations miss the brute-force sums."""
    pos, box, tree, linked, _, _ = deep
    n = pos.shape[0]
    rng = np.random.RandomState(4)
    m = torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32))
    layout = leaf_layout_from_counts(tree.counts)
    cap_leaf = linked.leaves.shape[0] - 1
    centers = upsweep_centers(linked, compute_leaf_source_centers(pos[:, 0], pos[:, 1], pos[:, 2], m, layout,
                                                                  cap_leaf))
    mac_sq = set_mac_radii(linked, centers, 1.0 / theta, box)[:, 3]
    ax, ay, az, ovf = gravity_monopole(pos[:, 0], pos[:, 1], pos[:, 2], m, linked, layout, centers, mac_sq, None,
                                       None, box, group_size=8, leaf_cap=4096, cand_cap=4096, chunk=8)
    assert int(ovf) == 0
    a = torch.stack([ax, ay, az], -1).double().numpy()
    ref = _bh_brute(pos, m, linked, layout, centers, mac_sq, box, 8)
    err = np.linalg.norm(a - ref, axis=1) / np.linalg.norm(ref, axis=1)
    assert err.max() < 1e-4
