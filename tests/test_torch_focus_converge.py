"""focus_converge of the PyTorch port against the JAX package: from the
root and from a carried tree, MAC marking off and on, counts from the
sorted pool and from a leaf_counts_fn, a capacity too small (overflow =
required size) and max_iters too small (overflow = cap_leaf + 1).
Tolerance: all seven outputs bit-equal (the linked tree's permutation
arrays over their valid part). The JAX side is jitted, as Domain.sync is
in the JAX package's own tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cstone_tpu.domain.decomposition import make_sfc_assignment as jax_assignment
from cstone_tpu.focus.octree_focus import focus_converge as jax_focus_converge
from cstone_tpu.focus.octree_focus import focus_update_once as jax_update_once
from cstone_tpu.focus.octree_focus import pool_leaf_counts as jax_pool_counts
from cstone_tpu.sfc import PERIODIC
from cstone_tpu.sfc import compute_sfc_keys as jax_sfc_keys
from cstone_tpu.sfc import make_box as jax_make_box
from cstone_tpu.traversal.macs import inv_theta_min_mac
from cstone_tpu.tree import octree as joct
from cstone_tpu.tree.csarray import compute_octree as jax_compute_octree
from cstone_tpu.tree.csarray import root_tree as jax_root_tree
from cstone_tpu_torch.focus import octree_focus as tfocus
from cstone_tpu_torch.interop import from_numpy_tree
from cstone_tpu_torch.ops.keys64 import from_numpy, to_numpy
from cstone_tpu_torch.sfc import make_box
from cstone_tpu_torch.tree import build_linked_octree, upsweep_sum

import torch_threads  # noqa: F401  (two intra-op threads per xdist worker)

N = 3000
BUCKET = 16
INV_THETA = inv_theta_min_mac(1.0)


def _pool(seed, gauss=False):
    """Sorted uint64 Hilbert keys of N points in the periodic unit box."""
    rng = np.random.RandomState(seed)
    pos = rng.normal(0.5, 0.12, (N, 3)) % 1.0 if gauss else rng.uniform(0, 1, (N, 3))
    pos = pos.astype(np.float32)
    box = jax_make_box(0.0, 1.0, boundaries=PERIODIC)
    keys = jax_sfc_keys(*(jnp.asarray(pos[:, d]) for d in range(3)), box, jnp.uint64)
    return np.sort(np.asarray(keys)), box, make_box(0.0, 1.0, boundaries=PERIODIC, device="cpu")


def _boundaries(pool, n_ranks):
    t = jax_compute_octree(jnp.asarray(pool), 64, capacity=1024)
    return np.asarray(jax_assignment(t.keys, t.counts, t.n_nodes, n_ranks).boundaries)


def _assert_same(j, t, name, n=None):
    a = np.asarray(j)
    b = to_numpy(t) if a.dtype in (np.uint32, np.uint64) else np.asarray(t)
    if n is not None:
        a, b = a[:n], b[:n]
    np.testing.assert_array_equal(b, a, err_msg=name)


def _assert_outputs_same(jout, tout):
    jl, tl = jout[2], tout[2]
    _assert_same(jout[0], tout[0], "leaves")
    assert int(jout[1]) == int(tout[1]), "n_leaf"
    for f in ("prefixes", "child_offsets", "parents", "level_range", "leaves"):
        _assert_same(getattr(jl, f), getattr(tl, f), "linked." + f)
    _assert_same(jl.internal_to_leaf, tl.internal_to_leaf, "internal_to_leaf", int(jl.n_nodes))
    _assert_same(jl.leaf_to_internal, tl.leaf_to_internal, "leaf_to_internal", int(jl.n_nodes))
    _assert_same(jout[3], tout[3], "node_counts")
    assert int(jout[4]) == int(tout[4]), "overflow"
    assert int(jout[5]) == int(tout[5]), "count service overflow"
    assert bool(jout[6]) == bool(tout[6]), "converged"


def _run_both(pool, jbox, tbox, cap, focus, mandatory, skip_macs, max_iters=32, leaves0=None,
              linked0=None, use_carried=None, counts_fn=False, bucket=BUCKET):
    """focus_converge in JAX (jitted) and in the port on the same inputs."""
    if leaves0 is None:
        leaves0, n0 = np.asarray(jax_root_tree(jnp.uint64, cap).keys), 1
    else:
        leaves0, n0 = leaves0
    static = dict(bucket_size_focus=bucket, inv_theta_eff=INV_THETA, max_iters=max_iters, skip_macs=skip_macs)
    jpool, tpool = jnp.asarray(pool), from_numpy(pool)
    if counts_fn:
        # once plain counts, once (counts, overflow)
        jfn = lambda lv, n: (jax_pool_counts(jpool, lv, N), jnp.int32(0))  # noqa: E731
        tfn = lambda lv, n: tfocus.pool_leaf_counts(tpool, lv, N)  # noqa: E731
        jcall = lambda lv, n, b, fs, fe, mk, l0, uc: jax_focus_converge(  # noqa: E731
            lv, n, None, None, b, fs, fe, mk, leaf_counts_fn=jfn, linked0=l0, use_carried=uc, **static)
        targs = (None, None)
        tkw = dict(leaf_counts_fn=tfn)
    else:
        jcall = lambda lv, n, b, fs, fe, mk, l0, uc: jax_focus_converge(  # noqa: E731
            lv, n, jpool, N, b, fs, fe, mk, linked0=l0, use_carried=uc, **static)
        targs = (tpool, N)
        tkw = {}
    jl0 = None if linked0 is None else linked0
    jout = jax.jit(jcall)(jnp.asarray(leaves0), jnp.int32(n0), jbox, focus[0], focus[1], jnp.asarray(mandatory),
                          jl0, None if use_carried is None else jnp.bool_(use_carried))
    tl0 = None if linked0 is None else from_numpy_tree(linked0, device="cpu")
    tout = tfocus.focus_converge(
        from_numpy(leaves0), n0, *targs, tbox, from_numpy(np.array(focus[0])), from_numpy(np.array(focus[1])),
        from_numpy(mandatory), linked0=tl0, use_carried=use_carried, **static, **tkw)
    _assert_outputs_same(jout, tout)
    return jout, tout


def test_converge_from_root_whole_domain_is_the_cornerstone_tree():
    # one rank: the focus is everything, MACs are skipped, and the fixed
    # point is the cornerstone tree of the focus bucket
    pool, jbox, tbox = _pool(1)
    mandatory = _boundaries(pool, 1)
    jout, tout = _run_both(pool, jbox, tbox, 1024, (mandatory[0], mandatory[1]), mandatory, skip_macs=True)
    assert bool(tout[6]) and int(tout[4]) == 0
    t = jax_compute_octree(jnp.asarray(pool), BUCKET, capacity=1024)
    _assert_same(t.keys, tout[0], "cornerstone")
    assert int(t.n_nodes) == int(tout[1])


@pytest.mark.parametrize("gauss", [False, True])
def test_converge_with_macs_and_carried_tree(gauss):
    # rank 3 of 8: fine inside its range, MAC-coarsened outside, every
    # assignment boundary resolved
    pool, jbox, tbox = _pool(2, gauss)
    mandatory = _boundaries(pool, 8)
    focus = (mandatory[3], mandatory[4])
    # bucket 4: a tree deep enough (4-5 levels) for the MAC to pass far nodes
    jout, tout = _run_both(pool, jbox, tbox, 4096, focus, mandatory, skip_macs=False, bucket=4)
    assert bool(tout[6]) and int(tout[4]) == 0
    leaves = to_numpy(tout[0])[:int(tout[1]) + 1]
    assert np.isin(mandatory, leaves).all()
    full = jax_compute_octree(jnp.asarray(pool), 4, capacity=4096)
    assert int(tout[1]) < int(full.n_nodes)  # coarser than the cornerstone tree outside the focus
    inside = (leaves >= focus[0]) & (leaves <= focus[1])
    fk = np.asarray(full.keys)[:int(full.n_nodes) + 1]
    np.testing.assert_array_equal(leaves[inside], fk[(fk >= focus[0]) & (fk <= focus[1])])

    # warm: the particles drift, the carried tree and its linked structure are reused
    rng = np.random.RandomState(3)
    drifted = np.sort(np.clip(pool.astype(np.float64) + rng.normal(0, 2.0 ** 44, N), 0, 2.0 ** 63 - 2 ** 12)
                      .astype(np.uint64))
    # (one variant per distribution: each is a compile of the JAX side)
    carried = (np.asarray(jout[0]), int(jout[1]))
    for use_carried in ((True,) if gauss else (False,)):
        _, tw = _run_both(drifted, jbox, tbox, 4096, focus, mandatory, skip_macs=False, leaves0=carried,
                          linked0=jout[2], use_carried=use_carried, counts_fn=not use_carried, bucket=4)
        assert bool(tw[6]) and int(tw[4]) == 0


@pytest.mark.parametrize("limit", ["capacity", "max_iters"])
def test_converge_reports_overflow_and_non_convergence(limit):
    pool, jbox, tbox = _pool(4)
    mandatory = _boundaries(pool, 1)
    focus = (mandatory[0], mandatory[1])
    if limit == "capacity":
        cap = 100
        _, tout = _run_both(pool, jbox, tbox, cap, focus, mandatory, skip_macs=True)
        # the overflow is the size the tree asked for
        assert int(tout[4]) > cap
    else:
        cap = 1024
        _, tout = _run_both(pool, jbox, tbox, cap, focus, mandatory, skip_macs=True, max_iters=2)
        assert not bool(tout[6]) and int(tout[4]) == cap + 1


def test_update_once_with_a_key_far_below_its_leaf_injects_it():
    # a mandatory key 3 levels below a leaf: enforce_keys fails, and the
    # step splices the key's spanning cover into the leaf array
    pool, jbox, tbox = _pool(5)
    t = jax_compute_octree(jnp.asarray(pool), 64, capacity=1024)
    jl = joct.build_linked_octree(t.keys, t.n_nodes)
    tl = from_numpy_tree(jl, device="cpu")
    leaves = np.asarray(t.keys)
    i = int(t.n_nodes) // 2
    key = leaves[i] + ((leaves[i + 1] - leaves[i]) >> np.uint64(9)) * np.uint64(5)
    mandatory = np.array([0, key, 1 << 63], np.uint64)
    jcounts = joct.upsweep_sum(jl, t.counts, saturate_u32=True)
    tcounts = upsweep_sum(tl, torch.from_numpy(np.asarray(t.counts).astype(np.int64)), saturate_u32=True)
    _assert_same(jcounts, tcounts, "node counts")
    macs = np.zeros(len(np.asarray(jcounts)), bool)
    jo = jax_update_once(jl, jcounts, jnp.asarray(macs), mandatory[0], mandatory[2], jnp.asarray(mandatory), 64)
    to = tfocus.focus_update_once(tl, tcounts, torch.from_numpy(macs), 0, -2 ** 63, from_numpy(mandatory), 64)
    _assert_same(jo[0], to[0], "leaves")
    assert int(jo[1]) == int(to[1]) > int(t.n_nodes)
    assert bool(jo[2]) == to[2] is False
    assert key in to_numpy(to[0])
    # the port's tree builds from it
    assert int(build_linked_octree(to[0], to[1]).n_leaf) == int(to[1])
