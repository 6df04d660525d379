"""The Halos state machine of the PyTorch port (halos/halos.py) against
the JAX package's at one rank, and at 8 ranks (run_ranks threads) against
the port's own p2p Domain, whose sync runs the same discover, layout and
exchange steps.

Tolerance: none. Halo flags, layouts, the halo record and the exchanged
fields are bit-equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cstone_tpu.domain.layout import leaf_layout_from_counts
from cstone_tpu.halos import Halos as JaxHalos
from cstone_tpu.sfc import PERIODIC, compute_sfc_keys, make_box as jax_make_box
from cstone_tpu.tree import compute_octree
from cstone_tpu.tree.octree import build_linked_octree
from cstone_tpu_torch.domain import Domain
from cstone_tpu_torch.domain.layout import leaf_layout_from_counts as port_leaf_layout
from cstone_tpu_torch.halos import Halos
from cstone_tpu_torch.interop import from_numpy_tree
from cstone_tpu_torch.ops.keys64 import from_numpy as keys_from_numpy
from cstone_tpu_torch.ops.primitives import searchsorted
from cstone_tpu_torch.parallel import run_ranks
from cstone_tpu_torch.sfc import make_box
from cstone_tpu_torch.sfc.keys import remove_key
from tests.test_torch_domain_pool import CAP, KW, N_PER, R, initial

import torch_threads  # noqa: F401  (two intra-op threads per xdist worker)

HALO_FIELDS = ("send_idx", "send_valid", "recv_idx", "recv_valid", "overflow")


@pytest.mark.parametrize("periodic", [True, False])
def test_halos_one_rank_match_jax(periodic):
    """One rank owning every particle, its assignment a middle range of
    leaves: the halos it requests are served by itself."""
    n = 2000
    rng = np.random.RandomState(8)
    pos = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    h = rng.uniform(0.02, 0.05, size=n).astype(np.float32)
    jbox = jax_make_box(-1.0, 1.0, boundaries=PERIODIC if periodic else 0)
    keys = np.asarray(compute_sfc_keys(*(jnp.asarray(pos[:, i]) for i in range(3)), jbox, jnp.uint64))
    order = np.argsort(keys, kind="stable")
    keys, pos, h = keys[order], pos[order], h[order]
    tree = compute_octree(jnp.asarray(keys), bucket_size=16, capacity=1024)
    linked = build_linked_octree(tree.keys, tree.n_nodes)
    counts = np.asarray(tree.counts).astype(np.int64)
    n_leaf = int(linked.n_leaf)
    first, last = n_leaf // 3, 2 * n_leaf // 3
    bounds = np.array([0, 1 << 63], np.uint64)

    jh = JaxHalos(1)
    jflags = jh.discover(linked, jnp.asarray(h), n, jnp.asarray(keys), first, last, jbox)
    jlay, js, je, jrec = jh.compute_layout(linked, jnp.asarray(counts.astype(np.uint32)), jflags, first, last,
                                           jnp.asarray(bounds), 0, jnp.asarray(keys), n, 256, 2048)
    jbuf = jnp.zeros(n, jnp.float32)
    jx = jh.exchange(jnp.asarray(pos[:, 0]), jbuf, jrec)

    th = Halos(search_ext_factor=1.0)
    tlinked = from_numpy_tree(linked, device="cpu")
    tbox = make_box(-1.0, 1.0, boundaries=int(periodic), device="cpu")
    tkeys = keys_from_numpy(keys, "cpu")
    tflags = th.discover(tlinked, torch.from_numpy(h), n, tkeys, first, last, tbox)
    tlay, ts, te, trec = th.compute_layout(tlinked, torch.from_numpy(counts), tflags, first, last,
                                           keys_from_numpy(bounds, "cpu"), tkeys, n, 256, 2048)
    tx = th.exchange(torch.from_numpy(pos[:, 0].copy()), torch.zeros(n), trec)

    np.testing.assert_array_equal(tflags.numpy(), np.asarray(jflags))
    assert 0 < int(tflags.sum()) < n_leaf - (last - first)
    np.testing.assert_array_equal(tlay.numpy(), np.asarray(jlay))
    assert int(ts) == int(js) and int(te) == int(je)
    for f in HALO_FIELDS:
        np.testing.assert_array_equal(getattr(trec, f).numpy(), np.asarray(getattr(jrec, f)), err_msg=f)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    # every halo slot holds the coordinate of the particle of its leaf
    lay = tlay.numpy()
    for leaf in np.nonzero(tflags.numpy())[0][:20]:
        a, b = int(lay[leaf]), int(lay[leaf + 1])
        lo = int(np.asarray(leaf_layout_from_counts(tree.counts))[leaf])
        np.testing.assert_array_equal(tx.numpy()[a:b], pos[lo:lo + b - a, 0])
    np.testing.assert_array_equal(port_leaf_layout(torch.from_numpy(counts)).numpy(),
                                  np.asarray(leaf_layout_from_counts(tree.counts)))


def _rank(comm, cols, n_local):
    """One p2p sync, then Halos on its focus tree and owned particles."""
    d = Domain(comm=comm, device="cpu", **KW)
    tbox = make_box(-1.0, 1.0, boundaries=PERIODIC, device="cpu")
    x, y, z, h, m = (torch.from_numpy(np.ascontiguousarray(c)) for c in cols)
    state, res = d.sync(d.init_state(box=tbox, boundaries=tbox.boundaries), x, y, z, h, properties=(m,),
                        n_local=int(n_local))
    j = torch.arange(CAP)
    n_owned = res.end_index - res.start_index
    take = torch.clamp(res.start_index + j, max=CAP - 1)
    okeys = torch.where(j < n_owned, res.keys[take], remove_key(np.uint64))
    first, last = searchsorted(res.tree.leaves, state.assignment.boundaries[comm.rank:comm.rank + 2])
    halos = Halos(comm)
    flags = halos.discover(res.tree, res.h[take], n_owned, okeys, first, last, state.box)
    _, _, req_cap, halo_cap = d._p2p_caps(CAP)
    layout, start, end, rec = halos.compute_layout(res.tree, res.leaf_counts, flags, first, last,
                                                   state.assignment.boundaries, okeys, n_owned, req_cap, halo_cap)
    owned = (j >= start) & (j < end)
    fields = [halos.exchange(a[take], torch.where(owned, a, 0.0), rec) for a in (res.x, res.y, res.z, res.h)]
    return res, flags, layout, start, end, rec, fields


def test_halos_eight_ranks_match_the_domain():
    cols, _, _, _ = initial(seed=23)
    outs = run_ranks(R, _rank, [cols[:, r] for r in range(R)], [N_PER] * R)
    total = 0
    for r, (res, flags, layout, start, end, rec, fields) in enumerate(outs):
        assert int(res.overflow) == 0
        assert torch.equal(flags, res.halo_flags), f"rank {r}: halo flags"
        assert torch.equal(layout, res.layout), f"rank {r}: layout"
        assert int(start) == int(res.start_index) and int(end) == int(res.end_index)
        for f in HALO_FIELDS:
            assert torch.equal(getattr(rec, f), getattr(res.halo_record, f)), f"rank {r}: {f}"
        n = int(res.n_with_halos)
        for name, got in zip("xyzh", fields):
            assert torch.equal(got[:n], getattr(res, name)[:n]), f"rank {r}: exchanged {name}"
        total += int(flags.sum())
    assert total > 0
