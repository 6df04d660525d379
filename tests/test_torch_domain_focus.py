"""Domain.sync of the PyTorch port with a focus tree of its own (bucket
and capacity different from the global tree's) against the JAX package:
four drifting steps with the carried state, buckets (64, 8) on uniform
and (8, 64) on Gaussian particles, then the cell-list neighbor counts on
the synced arrays. Tolerance: every SyncResult field and the carried
DomainState bit-equal, slot for slot. The JAX sync is jitted (one compile
per configuration), as in the JAX package's own Domain tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import cstone_tpu_torch
from cstone_tpu.domain.domain import Domain as JaxDomain
from cstone_tpu.sfc import PERIODIC
from cstone_tpu.sfc import make_box as jax_make_box
from cstone_tpu.traversal import celllist as jcl
from cstone_tpu_torch.domain import CAP_NAMES, Domain, sync_with_retry
from cstone_tpu_torch.focus import octree_focus
from cstone_tpu_torch.ops.keys64 import to_numpy
from cstone_tpu_torch.sfc import make_box
from cstone_tpu_torch.traversal import celllist as tcl
from tests.test_torch_domain import _advance, _assert_same, _assert_sync_same, _sync

import torch_threads  # noqa: F401  (two intra-op threads per xdist worker)

N = 4000
CONFIGS = {
    # name: (bucket, focus bucket, tree capacity, focus capacity, gaussian)
    "coarse-global-fine-focus-uniform": (64, 8, 512, 3000, False),
    "fine-global-coarse-focus-gauss": (8, 64, 3000, 700, True),
}


def _particles(seed, gauss):
    rng = np.random.RandomState(seed)
    if gauss:
        pos = np.clip(rng.normal(0.0, 0.3, (N, 3)), -0.999, 0.999).astype(np.float32)
    else:
        pos = rng.uniform(-1, 1, (N, 3)).astype(np.float32)
    h = np.full(N, 0.05, np.float32)
    drift = rng.uniform(-0.02, 0.02, (N, 3)).astype(np.float32)
    return pos, h, drift


def _port_domain(bucket, focus_bucket, cap_tree, cap_focus):
    td = Domain(bucket_size=bucket, bucket_size_focus=focus_bucket, tree_capacity=cap_tree,
                focus_capacity=cap_focus, device="cpu")
    tbox = make_box(-1.0, 1.0, boundaries=PERIODIC, device="cpu")
    return td, td.init_state(box=tbox, boundaries=tbox.boundaries), tbox


def _assert_state_same(js, ts):
    _assert_same(js.focus_leaves, ts.focus_leaves, "state.focus_leaves")
    assert int(js.focus_n) == int(ts.focus_n)
    assert bool(js.first_call) == ts.first_call
    _assert_same(js.linked.prefixes, ts.linked.prefixes, "state.linked.prefixes")
    _assert_same(js.linked.child_offsets, ts.linked.child_offsets, "state.linked.child_offsets")
    _assert_same(js.assignment.counts, ts.assignment.counts, "state.assignment.counts")
    _assert_same(js.global_tree.n_nodes, ts.global_tree.n_nodes, "state.global_tree.n_nodes")


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_sync_with_own_focus_tree_matches_jax(name):
    bucket, focus_bucket, cap_tree, cap_focus, gauss = CONFIGS[name]
    pos, h, drift = _particles(5, gauss)
    jd = JaxDomain(rank=0, n_ranks=1, bucket_size=bucket, bucket_size_focus=focus_bucket,
                   key_dtype=jnp.uint64, tree_capacity=cap_tree, focus_capacity=cap_focus)
    jbox = jax_make_box(-1.0, 1.0, boundaries=PERIODIC)
    js = jd.init_state(box=jbox, boundaries=jbox.boundaries)
    jsync = jax.jit(jd.sync)
    td, ts, tbox = _port_domain(bucket, focus_bucket, cap_tree, cap_focus)
    assert ts.focus_leaves.shape[0] == cap_focus + 1 != ts.global_tree.keys.shape[0]
    _assert_state_same(js, ts)

    # the port's own fast_focus Domain at the focus bucket: the same tree
    fd, fs, _ = _port_domain(focus_bucket, focus_bucket, cap_focus, cap_focus)

    for _ in range(4):
        js, jr = jsync(js, *(jnp.asarray(pos[:, i]) for i in range(3)), jnp.asarray(h))
        ts, tr = _sync(td, ts, pos, h, port=True)
        _assert_sync_same(js, jr, ts, tr)
        _assert_state_same(js, ts)
        assert int(tr.overflow) == 0 and ts.focus_converged
        assert int(tr.tree.n_leaf) != int(ts.global_tree.n_nodes)

        fs, fr = _sync(fd, fs, pos, h, port=True)
        np.testing.assert_array_equal(to_numpy(tr.tree.leaves), to_numpy(fr.tree.leaves))
        np.testing.assert_array_equal(tr.leaf_counts.numpy(), fr.leaf_counts.numpy())
        np.testing.assert_array_equal(tr.layout.numpy(), fr.layout.numpy())
        assert int(tr.tree.n_leaf) == int(fr.tree.n_leaf)
        pos = _advance(pos, drift, True)

    if gauss:
        return  # one compile of the JAX counts is enough
    # downstream: cell-list counts on the synced arrays
    level, cap = 3, 512
    jc, jovf = jcl.cell_list_neighbor_counts(jr.keys, jr.x, jr.y, jr.z, jr.h, js.box, level, cap, impl="xla")
    tc, tovf = tcl.cell_list_neighbor_counts(tr.keys, tr.x, tr.y, tr.z, tr.h, ts.box, level, cap)
    assert not bool(jovf) and not bool(tovf)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert int(tc.sum()) > 0


def test_warm_converged_step_reuses_the_carried_linked_tree():
    # particles at rest: the second sync converges in its first iteration,
    # which takes the carried linked tree instead of building one
    pos, h, _ = _particles(6, False)
    td, ts, _ = _port_domain(64, 8, 512, 3000)
    builds = []
    real_build = octree_focus.build_linked_octree
    octree_focus.build_linked_octree = lambda *a, **k: builds.append(1) or real_build(*a, **k)
    try:
        ts, r1 = _sync(td, ts, pos, h, port=True)
        cold = len(builds)
        ts, r2 = _sync(td, ts, pos, h, port=True)
    finally:
        octree_focus.build_linked_octree = real_build
    assert cold >= 3 and len(builds) == cold
    assert r2.tree is r1.tree and ts.focus_converged


def test_sync_continues_from_jax_state_with_own_focus_capacity():
    # step 1 in JAX, its state (focus arrays of their own capacity) carried
    # into the port, step 2 in both
    bucket, focus_bucket, cap_tree, cap_focus, gauss = CONFIGS["fine-global-coarse-focus-gauss"]
    pos, h, drift = _particles(9, gauss)
    jd = JaxDomain(rank=0, n_ranks=1, bucket_size=bucket, bucket_size_focus=focus_bucket,
                   key_dtype=jnp.uint64, tree_capacity=cap_tree, focus_capacity=cap_focus)
    jbox = jax_make_box(-1.0, 1.0, boundaries=PERIODIC)
    jsync = jax.jit(jd.sync)
    js, _ = jsync(jd.init_state(box=jbox, boundaries=jbox.boundaries),
                  *(jnp.asarray(pos[:, i]) for i in range(3)), jnp.asarray(h))
    ts = cstone_tpu_torch.from_numpy_state(js, device="cpu")
    assert ts.focus_leaves.shape[0] == cap_focus + 1 and ts.linked.leaves.shape[0] == cap_focus + 1
    assert ts.global_tree.keys.shape[0] == cap_tree + 1
    td, _, _ = _port_domain(bucket, focus_bucket, cap_tree, cap_focus)
    pos = _advance(pos, drift, True)
    js, jr = jsync(js, *(jnp.asarray(pos[:, i]) for i in range(3)), jnp.asarray(h))
    ts, tr = _sync(td, ts, pos, h, port=True)
    _assert_sync_same(js, jr, ts, tr)
    _assert_state_same(js, ts)


def test_retry_grows_a_focus_capacity_that_starts_too_small():
    pos, h, _ = _particles(2, False)
    calls = []

    def run(caps):
        calls.append(dict(caps))
        d = Domain(bucket_size=64, bucket_size_focus=8, tree_capacity=caps["tree"],
                   focus_capacity=caps["focus"], device="cpu")
        box = make_box(-1.0, 1.0, boundaries=PERIODIC, device="cpu")
        _, res = _sync(d, d.init_state(box=box, boundaries=box.boundaries), pos, h, port=True)
        return res

    res, caps = sync_with_retry(run, {"tree": 512, "focus": 64})
    assert int(res.overflow) == 0 and len(calls) >= 2
    assert caps["focus"] > 64 and caps["tree"] == 512
    first = run({"tree": 512, "focus": 64})
    detail = first.overflow_detail.numpy()
    # the focus entry names the size the tree asked for, no other capacity overflows
    assert detail[CAP_NAMES.index("focus")] > 64 and int(first.overflow) == detail.max()
    assert (np.delete(detail, CAP_NAMES.index("focus")) == 0).all()


def test_retry_names_non_convergence(monkeypatch):
    # a converge loop cut at one iteration reports cap_leaf + 1, which no
    # growth of the capacity cures: the retry loop says so
    pos, h, _ = _particles(3, False)
    real = octree_focus.focus_converge
    import cstone_tpu_torch.domain.domain as dom
    monkeypatch.setattr(dom, "focus_converge", lambda *a, **k: real(*a, **{**k, "max_iters": 1}))

    def run(caps):
        d = Domain(bucket_size=64, bucket_size_focus=8, tree_capacity=512,
                   focus_capacity=caps["focus"], device="cpu")
        box = make_box(-1.0, 1.0, boundaries=PERIODIC, device="cpu")
        return _sync(d, d.init_state(box=box, boundaries=box.boundaries), pos, h, port=True)[1]

    with pytest.raises(RuntimeError, match="NON-CONVERGENCE"):
        sync_with_retry(run, {"tree": 512, "focus": 4000}, max_retries=1)
