"""The depth-first leaf walk, the dual traversal and dual-traversal peer
discovery of the PyTorch port against the JAX package
(cstone_tpu/traversal/traversal.py, peers.py).

Tolerances: batched_collect_leaves' counts are exact and each row holds
the same leaves as JAX's (compared as a set: the port walks breadth
first, JAX depth first); dual_traversal's close leaf pairs are the same
set and n_out is exact; peer masks are bit-equal to JAX's dual form and
to the port's single-traversal form (find_peers_mac)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cstone_tpu.traversal.boxoverlap import min_distance_boxes as jax_min_distance_boxes
from cstone_tpu.traversal.peers import find_peers_mac_dual as jax_peers_dual
from cstone_tpu.traversal.traversal import batched_collect_leaves as jax_collect
from cstone_tpu.traversal.traversal import dual_traversal as jax_dual
from cstone_tpu.tree.octree import node_keys_and_levels as jax_keys_and_levels
from cstone_tpu_torch.domain.decomposition import SfcAssignment
from cstone_tpu_torch.interop import from_numpy_tree
from cstone_tpu_torch.ops.keys64 import from_numpy as keys_from_numpy
from cstone_tpu_torch.sfc import make_box
from cstone_tpu_torch.traversal.boxoverlap import min_distance_boxes
from cstone_tpu_torch.traversal.macs import inv_theta_min_mac
from cstone_tpu_torch.traversal.peers import find_peers_mac, find_peers_mac_dual
from cstone_tpu_torch.traversal.traversal import batched_collect_leaves, dual_traversal
from tests.test_peers import _setup as peers_setup
from tests.test_torch_neighbors import _views
from tests.test_torch_traversal import _queries

import torch_threads  # noqa: F401  (two intra-op threads per xdist worker)


def _rows_as_sets(leaves, counts):
    leaves, counts = np.asarray(leaves), np.asarray(counts)
    return [set(leaves[q, :min(int(counts[q]), leaves.shape[1])].tolist()) for q in range(leaves.shape[0])]


@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("masked", [False, True])
def test_collect_leaves_matches_jax_as_sets(periodic, masked):
    _, box, jview, tbox, tview, linked = _views(3000, periodic, seed=7)
    n_q = 37
    jcrit, tcrit = _queries((jview.centers, jview.sizes, tview.centers, tview.sizes), (box, tbox), n_q, 0.2, 11,
                            periodic)
    active = np.arange(n_q) % 4 != 1 if masked else None
    jl, jn = jax_collect(linked.child_offsets, jcrit, n_q, 512,
                         active_mask=None if active is None else jnp.asarray(active))
    tl, tn = batched_collect_leaves(tview.tree.child_offsets, tcrit, n_q, 512,
                                    active_mask=None if active is None else torch.from_numpy(active))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    assert int(tn.max()) <= 512 and int(tn.min()) >= 0 and int(tn.sum()) > n_q
    assert _rows_as_sets(tl, tn) == _rows_as_sets(jl, jn)
    # padding past each row's count, and every leaf is a leaf node
    k = torch.arange(512)
    assert bool((tl[k[None, :] >= tn[:, None]] == -1).all())
    assert bool((tview.tree.child_offsets[tl[tl >= 0]] == 0).all())

    # a short row capacity: exact counts, and the kept leaves are some of
    # the row's leaves, as many as fit
    tl8, tn8 = batched_collect_leaves(tview.tree.child_offsets, tcrit, n_q, 8,
                                      active_mask=None if active is None else torch.from_numpy(active))
    np.testing.assert_array_equal(tn8.numpy(), tn.numpy())
    full = _rows_as_sets(tl, tn)
    for q, row in enumerate(_rows_as_sets(tl8, tn8)):
        assert row <= full[q] and len(row) == min(8, int(tn[q]))


def _dual_setup(periodic, radius):
    _, box, jview, tbox, tview, linked = _views(3000, periodic, seed=3)
    _, _, jlev = jax_keys_and_levels(linked)
    tlev = torch.from_numpy(np.asarray(jlev).astype(np.int64))
    r = np.float32(radius)

    def jclose(a, b):
        d = jax_min_distance_boxes(jview.centers[a], jview.sizes[a], jview.centers[b], jview.sizes[b],
                                   box if periodic else None)
        return jnp.sum(d * d, axis=-1) < r * r

    def tclose(a, b):
        d = min_distance_boxes(tview.centers[a], tview.sizes[a], tview.centers[b], tview.sizes[b],
                               tbox if periodic else None)
        return d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2] < r * r

    return linked, jlev, jclose, tview, tlev, tclose


def _pairs(a, b, n):
    a, b = np.asarray(a), np.asarray(b)
    return set(zip(a[:int(n)].tolist(), b[:int(n)].tolist()))


@pytest.mark.parametrize("periodic", [True, False])
def test_dual_traversal_matches_jax_as_sets(periodic):
    linked, jlev, jclose, tview, tlev, tclose = _dual_setup(periodic, 0.05)
    ja, jb, jn, jo = jax_dual(linked.child_offsets, jlev, jclose, 65536)
    ta, tb, tn, to = dual_traversal(tview.tree.child_offsets, tlev, tclose, 65536)
    assert int(jo) == 0 and int(to) == 0
    assert int(tn) == int(jn) > 0
    assert _pairs(ta, tb, tn) == _pairs(ja, jb, jn)
    assert bool((ta[int(tn):] == -1).all()) and bool((tb[int(tn):] == -1).all())
    # every emitted pair is two close leaves
    leaf = tview.tree.child_offsets == 0
    assert bool(leaf[ta[:int(tn)]].all() and leaf[tb[:int(tn)]].all())
    assert bool(tclose(ta[:int(tn)], tb[:int(tn)]).all())

    # too small a capacity: both report an overflow
    _, _, _, jo = jax_dual(linked.child_offsets, jlev, jclose, 256)
    _, _, _, to = dual_traversal(tview.tree.child_offsets, tlev, tclose, 256)
    assert int(jo) > 256 and int(to) > 256


@pytest.fixture(scope="module")
def peers():
    linked, assignment, box = peers_setup(n_ranks=8)
    tlinked = from_numpy_tree(linked, device="cpu")
    tassign = SfcAssignment(boundaries=keys_from_numpy(np.asarray(assignment.boundaries), "cpu"),
                            counts=torch.from_numpy(np.asarray(assignment.counts).astype(np.int64)))
    return linked, assignment, box, tlinked, tassign, make_box(-1.0, 1.0, device="cpu")


def test_peers_dual_matches_stt_on_every_rank(peers):
    """The port's dual form equals its single-traversal form on every
    rank (test_peers.py::test_peers_dual_matches_stt)."""
    _, _, _, tlinked, tassign, tbox = peers
    inv_theta = inv_theta_min_mac(0.5)
    for r in range(8):
        dual, ovf = find_peers_mac_dual(r, tassign, tlinked, tbox, inv_theta, pair_cap=131072)
        assert int(ovf) == 0
        stt = find_peers_mac(r, tassign, tlinked, tbox, inv_theta)
        np.testing.assert_array_equal(dual.numpy(), stt.numpy())
        assert int(dual.sum()) > 0 and int(dual[r]) == 0


@pytest.mark.parametrize("rank", [0, 5])
def test_peers_dual_matches_jax(peers, rank):
    linked, assignment, box, tlinked, tassign, tbox = peers
    inv_theta = inv_theta_min_mac(0.5)
    jmask, jovf = jax_peers_dual(rank, assignment, linked, box, inv_theta, pair_cap=131072)
    tmask, tovf = find_peers_mac_dual(rank, tassign, tlinked, tbox, inv_theta, pair_cap=131072)
    assert int(jovf) == 0 and int(tovf) == 0
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
