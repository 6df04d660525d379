"""Octree traversal pieces of the PyTorch port against the JAX package:
node geometry, the BFS leaf walk, merge_leaf_runs and check_nb_stats.
Tolerance: bit-equal (leaf lists in the same emission order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cstone_tpu.ops.pallas_neighbors_v2 import merge_leaf_runs as jax_merge_leaf_runs
from cstone_tpu.traversal.boxoverlap import min_distance_boxes as jax_min_distance_boxes
from cstone_tpu.traversal.traversal import batched_collect_leaves_bfs as jax_bfs
from cstone_tpu_torch.interop import from_numpy_tree
from cstone_tpu_torch.ops.neighbors_v2 import merge_leaf_runs
from cstone_tpu_torch.traversal import geometry, neighbors as tnb
from cstone_tpu_torch.traversal.boxoverlap import min_distance_boxes
from cstone_tpu_torch.traversal.traversal import batched_collect_leaves_bfs
from tests.test_torch_neighbors import _views

import torch_threads  # noqa: F401  (two intra-op threads per xdist worker)


@pytest.mark.parametrize("curve", ["hilbert", "morton"])
@pytest.mark.parametrize("gauss", [False, True])
def test_node_geometry_matches_jax(curve, gauss):
    cols, box, jview, tbox, tview, linked = _views(2000, True, gauss, seed=5, curve=curve)
    c, s = geometry.node_geometry(from_numpy_tree(linked, device="cpu"), tbox, curve)
    np.testing.assert_array_equal(c.numpy(), np.asarray(jview.centers))
    np.testing.assert_array_equal(s.numpy(), np.asarray(jview.sizes))


def _queries(view, box, n_queries, radius, seed, periodic):
    rng = np.random.RandomState(seed)
    qc = rng.uniform(-1, 1, size=(n_queries, 3)).astype(np.float32)
    qs = rng.uniform(0.0, 0.3, size=(n_queries, 3)).astype(np.float32)
    r = np.float32(radius)

    def jcrit(q, nid):
        d = jax_min_distance_boxes(jnp.asarray(qc)[q], jnp.asarray(qs)[q], view[0][nid], view[1][nid],
                                   box[0] if periodic else None)
        return jnp.sum(d * d, axis=-1) < r * r

    tqc, tqs = torch.from_numpy(qc), torch.from_numpy(qs)

    def tcrit(q, nid):
        d = min_distance_boxes(tqc[q], tqs[q], view[2][nid], view[3][nid], box[1] if periodic else None)
        return d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2] < r * r

    return jcrit, tcrit


@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("frontier_cap", [64, 4])
def test_bfs_matches_jax(periodic, frontier_cap):
    _, box, jview, tbox, tview, linked = _views(3000, periodic, seed=7)
    jcrit, tcrit = _queries((jview.centers, jview.sizes, tview.centers, tview.sizes),
                            (box, tbox), 37, 0.2, 11, periodic)
    jl, jn, jf = jax_bfs(linked.child_offsets, jcrit, 37, 512, frontier_cap)
    tl, tn, tf = batched_collect_leaves_bfs(tview.tree.child_offsets, tcrit, 37, 512, frontier_cap)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    # a small frontier drops nodes and says so
    assert (int(tf.max()) > frontier_cap) == (frontier_cap == 4)


def test_merge_leaf_runs_matches_jax():
    rng = np.random.RandomState(2)
    n_groups, K, n_leaf = 23, 40, 300
    counts = rng.randint(0, 5, size=n_leaf)
    layout = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    leaf_idx = np.stack([rng.permutation(n_leaf)[:K] for _ in range(n_groups)]).astype(np.int32)
    leaf_idx[:, :10] = np.sort(leaf_idx[:, :10], axis=1)  # some adjacent ranges
    leaf_idx[3] = np.arange(40)  # one long run
    n_cand = rng.randint(0, K + 5, size=n_groups).astype(np.int32)
    for run_cap in (48, 6):
        j = jax_merge_leaf_runs(jnp.asarray(leaf_idx), jnp.asarray(n_cand), jnp.asarray(layout), run_cap)
        t = merge_leaf_runs(torch.from_numpy(leaf_idx).long(), torch.from_numpy(n_cand).long(),
                            torch.from_numpy(layout).long(), run_cap)
        for a, b in zip(t, j):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


CAPS = dict(cand_leaf_cap=640, frontier_cap=64, cand_cap=8192, run_cap=48)


@pytest.mark.parametrize("cap", sorted(CAPS) + ["pbc_bad"])
def test_check_nb_stats_raises_on_each_cap(cap):
    ok = dict(leaf_max=640, frontier_max=64, cand_max=8192, run_max=48, pbc_bad=False)
    tnb.check_nb_stats(tnb.NbStats(**{k: torch.tensor(v) for k, v in ok.items()}), **CAPS)
    field = {"cand_leaf_cap": "leaf_max", "frontier_cap": "frontier_max", "cand_cap": "cand_max",
             "run_cap": "run_max", "pbc_bad": "pbc_bad"}[cap]
    ok[field] = True if cap == "pbc_bad" else ok[field] + 1
    with pytest.raises(RuntimeError, match="periodic wrap" if cap == "pbc_bad" else f"raise {cap}"):
        tnb.check_nb_stats(tnb.NbStats(**{k: torch.tensor(v) for k, v in ok.items()}), **CAPS)
