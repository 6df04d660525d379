"""Tree-traversal neighbor search of the PyTorch port against the JAX
package (Pallas routes in interpret mode) and the O(n^2) oracle of
test_neighbors.py (its parts: test_torch_traversal.py).

Tolerances: NbStats and the counts of each route ("v2", "v1", False) are
bit-equal to the JAX route of the same name and equal to the oracle;
neighbor index lists are equal as sets per particle (the port emits them
in the same candidate order, and the set comparison is the contract)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cstone_tpu.domain.layout import leaf_layout_from_counts
from cstone_tpu.traversal import make_ns_view as jax_make_ns_view
from cstone_tpu.traversal import neighbors as jnb
from cstone_tpu.tree import compute_octree
from cstone_tpu.tree.octree import build_linked_octree
from cstone_tpu_torch.domain import Domain
from cstone_tpu_torch.interop import from_numpy_ns_view
from cstone_tpu_torch.ops import neighbors_v2
from cstone_tpu_torch.sfc import make_box
from cstone_tpu_torch.traversal import neighbors as tnb
from cstone_tpu_torch.utils.workloads import mixed_image_runs
from tests.test_neighbors import _setup, brute_force_counts

import torch_threads  # noqa: F401  (two intra-op threads per xdist worker)

# the group settings of test_neighbors.py
KW = dict(group_size=32, cand_cap=8192, cand_leaf_cap=640, chunk=16)


def _views(n, periodic, gauss=False, seed=1234, bucket=16, curve="hilbert", **setup_kw):
    x, y, z, h, keys, box = _setup(n, periodic, seed=seed, gauss=gauss, **setup_kw)
    tree = compute_octree(keys, bucket_size=bucket, capacity=2048)
    linked = build_linked_octree(tree.keys, tree.n_nodes)
    layout = leaf_layout_from_counts(tree.counts)
    jview = jax_make_ns_view(linked, layout, box, curve)
    tbox = make_box(-1.0, 1.0, boundaries=int(periodic), device="cpu")
    tview = from_numpy_ns_view(jview, device="cpu")
    cols = (x, y, z, h)
    return cols, box, jview, tbox, tview, linked


def _jax(cols):
    return tuple(jnp.asarray(a) for a in cols)


def _port(cols):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in cols)


@pytest.mark.parametrize("route", ["v2", "v1", False])
@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("gauss", [False, True])
def test_find_neighbors_matches_jax_and_bruteforce(route, periodic, gauss):
    cols, box, jview, tbox, tview, _ = _views(2000, periodic, gauss)
    jc, _ = jnb.find_neighbors(*_jax(cols), jview, box, use_pallas=route, **KW)
    tc, _ = tnb.find_neighbors(*_port(cols), tview, tbox, use_pallas=route, **KW)
    expect, _, _ = brute_force_counts(*cols, np.asarray(box.limits), periodic)
    np.testing.assert_array_equal(tc.numpy(), expect)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


@pytest.mark.parametrize("route", ["v2", "v1", False])
def test_nb_stats_match_jax(route):
    cols, box, jview, tbox, tview, _ = _views(1500, True, gauss=True, seed=3)
    args = (64, 32, 640, 8192, 16, False, 1500)
    _, _, js = jnb._find_neighbors_impl(*_jax(cols), jview, box, *args, use_pallas=route,
                                        frontier_cap=64, run_cap=48, tile=1024, interpret=True)
    _, _, ts = tnb._find_neighbors_impl(*_port(cols), tview, tbox, *args, use_pallas=route,
                                        frontier_cap=64, run_cap=48)
    for f in ("leaf_max", "frontier_max", "cand_max", "run_max", "pbc_bad"):
        assert int(getattr(ts, f)) == int(getattr(js, f)), f


@pytest.mark.parametrize("periodic", [False, True])
def test_neighbor_indices_match_jax_as_sets(periodic):
    cols, box, jview, tbox, tview, _ = _views(500, periodic, seed=7, bucket=8)
    kw = dict(ng_max=64, group_size=16, cand_cap=8192, cand_leaf_cap=640, with_indices=True)
    jc, jn = jnb.find_neighbors(*_jax(cols), jview, box, **kw)
    tc, tn = tnb.find_neighbors(*_port(cols), tview, tbox, **kw)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    jn, tn = np.asarray(jn), tn.numpy()
    assert tn.shape == jn.shape
    for i in range(jn.shape[0]):
        assert set(tn[i][tn[i] >= 0]) == set(jn[i][jn[i] >= 0]), i
    _, d2, r2 = brute_force_counts(*cols, np.asarray(box.limits), periodic)
    for i in range(0, 500, 37):
        assert set(tn[i][tn[i] >= 0]) == set(np.nonzero(d2[i] < r2[i])[0][:64])


def test_find_neighbors_raises_on_small_caps():
    cols, box, _, tbox, tview, _ = _views(1500, True, gauss=True, seed=3)
    with pytest.raises(RuntimeError, match="raise frontier_cap"):
        tnb.find_neighbors(*_port(cols), tview, tbox, **{**KW, "frontier_cap": 2})
    with pytest.raises(RuntimeError, match="raise run_cap"):
        tnb.find_neighbors(*_port(cols), tview, tbox, **{**KW, "run_cap": 2})
    with pytest.raises(RuntimeError, match="raise cand_cap"):
        tnb.find_neighbors(*_port(cols), tview, tbox, use_pallas="v1", **{**KW, "cand_cap": 64})


@pytest.mark.parametrize("periodic", [False, True])
def test_domain_ns_view_counts_vs_bruteforce(periodic):
    # Domain.sync -> Domain.ns_view -> find_neighbors, all in the port
    rng = np.random.RandomState(17)
    n = 1200
    pos = rng.uniform(0.0, 1.0, size=(n, 3)).astype(np.float32)
    h = rng.uniform(0.02, 0.05, size=n).astype(np.float32)
    box = make_box(0.0, 1.0, boundaries=int(periodic), device="cpu")
    domain = Domain(bucket_size=16, tree_capacity=1024, device="cpu")
    state = domain.init_state(box=box, boundaries=(int(periodic),) * 3)
    x, y, z, hh = _port((pos[:, 0], pos[:, 1], pos[:, 2], h))
    state, res = domain.sync(state, x, y, z, hh)
    view = domain.ns_view(res, state.box)
    counts, _ = tnb.find_neighbors(res.x, res.y, res.z, res.h, view, state.box, **KW)
    lims = state.box.limits.numpy()
    expect, _, _ = brute_force_counts(res.x.numpy(), res.y.numpy(), res.z.numpy(), res.h.numpy(),
                                      lims, periodic)
    np.testing.assert_array_equal(counts.numpy(), expect)


def _v2_args(periodic, seed=5, ng_max=4):
    """A synced 1,200-particle view of the unit box (h in [0.02, 0.05],
    about 5 neighbours): (columns and view of find_neighbors, B5's
    arguments for its groups of 32, the list mode's counts and lists by
    slot from the "v2" route and from the PyTorch route)."""
    rng = np.random.RandomState(seed)
    n = 1200
    pos = rng.uniform(0.0, 1.0, size=(n, 3)).astype(np.float32)
    h = rng.uniform(0.02, 0.05, size=n).astype(np.float32)
    box = make_box(0.0, 1.0, boundaries=int(periodic), device="cpu")
    domain = Domain(bucket_size=16, tree_capacity=1024, device="cpu")
    state = domain.init_state(box=box, boundaries=(int(periodic),) * 3)
    state, res = domain.sync(state, *_port((pos[:, 0], pos[:, 1], pos[:, 2], h)))
    view = domain.ns_view(res, state.box)
    cols = (res.x, res.y, res.z, res.h)
    kw = dict(ng_max=ng_max, group_size=32, cand_leaf_cap=640, cand_cap=8192, chunk=16, with_indices=True,
              n_targets=n)
    v2 = tnb._find_neighbors_impl(*cols, view, state.box, use_pallas="v2", **kw)
    torch_route = tnb._find_neighbors_impl(*cols, view, state.box, use_pallas=False, **{**kw, "ng_max": 64})
    return cols, view, state.box, v2, torch_route


@pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "open"])
def test_list_twin_matches_pytorch_route(periodic):
    """The "v2" route's lists (B5's list mode, its plain twin on the CPU)
    against the PyTorch route's: equal counts; where a count is at most
    ng_max the same neighbours, in ascending slot order; where it is more,
    ng_max distinct neighbours of the full list and the full count."""
    _, _, _, (counts, lists, _), (want_counts, want_lists, _) = _v2_args(periodic)
    ng_max = lists.shape[1]
    assert int(want_counts.max()) <= 64 and torch.equal(counts, want_counts)
    fits = counts <= ng_max
    assert 0 < int((~fits).sum()) < counts.numel()
    got = lists[fits]
    want = torch.where(want_lists[fits] >= 0, want_lists[fits], 1 << 40).sort(dim=1).values[:, :ng_max]
    assert torch.equal(torch.where(got >= 0, got, 1 << 40), want)
    for row, full in zip(lists[~fits], want_lists[~fits]):
        assert bool((row >= 0).all()) and bool((row[1:] > row[:-1]).all())
        assert set(row.tolist()) <= set(full[full >= 0].tolist())


def test_list_mode_counts_bit_equal_count_mode_and_dead_targets_list_nothing():
    """On B5's arguments with mixed images, the list twin's counts equal
    pairwise_count_runs_plain's bit for bit and each row is its target's
    first hits in run order; targets with r2 < 0 count 0 and list -1."""
    args = tuple(torch.from_numpy(a) for a in mixed_image_runs(32, 24, True))
    r2 = args[1].clone()
    r2[3, :5] = -1.0
    args = (args[0], r2) + args[2:]
    counts, lists = neighbors_v2.pairwise_list_runs(*args, 6)
    assert torch.equal(counts, neighbors_v2.pairwise_count_runs_plain(*args))
    assert int((counts > 6).sum()) > 0 and int(counts[3, :5].abs().sum()) == 0
    assert bool((lists[3, :5] == -1).all())
    n_live = (lists >= 0).sum(dim=-1)
    assert torch.equal(n_live, counts.clamp(max=6).long())
    assert bool(((lists[..., 1:] > lists[..., :-1]) | (lists[..., 1:] == -1)).all())
    wide_counts, wide = neighbors_v2.pairwise_list_runs_plain(*args, int(counts.max()))
    assert torch.equal(wide_counts, counts) and torch.equal(wide[..., :6], lists)


def test_list_route_choice(monkeypatch):
    """On CPU tensors the default route for lists is the PyTorch route
    (the JAX package's); "v2" takes B5's list mode (its plain twin here);
    a target offset raises on "v2"."""
    cols, view, box, _, _ = _v2_args(True)
    launched = []
    real = tnb.pairwise_list_runs
    monkeypatch.setattr(tnb, "pairwise_list_runs", lambda *a: launched.append(1) or real(*a))
    kw = dict(ng_max=16, group_size=32, cand_leaf_cap=640, cand_cap=8192, with_indices=True)
    tnb.find_neighbors(*cols, view, box, **kw)
    assert launched == []
    tnb.find_neighbors(*cols, view, box, use_pallas="v2", **kw)
    assert launched == [1]
    with pytest.raises(ValueError, match="target_offset"):
        tnb._find_neighbors_impl(*cols, view, box, 16, 32, 640, 8192, 16, True, 600, use_pallas="v2",
                                 target_offset=8)
