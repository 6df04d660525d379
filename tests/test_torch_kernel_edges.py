"""The plain versions of the one-sided stencil count (B4,
`stencil_counts_asym_plain`) and of the dense group x candidate count
(B6, `pairwise_count_plain`) held against the JAX package on the inputs
built to meet every edge of their kernels (utils/workloads.py): cell rows
of 0, 1, 32, 33 and 64 particles (before, at and past a 32-slot chunk),
open at level 2 and periodic at level 3, and the pairs across a periodic
wrap whose d2 differs between the ends (B4); group sizes 1, 33, 256 and 1024 over a candidate
count that is no multiple of a tile, with a group of no valid candidate,
holes of -1 slots, a target's own index at tile edges and targets with
r2 < 0 (B6). tests/test_torch_stencil_cuda.py and
tests/test_torch_neighbors_cuda.py hold the kernels to the plain versions
on the same inputs on the card.

Tolerance: counts equal (JAX's B6 counts are uint32, the port's int32:
values are compared)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cstone_tpu.ops.pallas_neighbors import pairwise_count as jax_pairwise_count
from cstone_tpu.sfc import make_box as jax_make_box
from cstone_tpu.traversal import celllist as jcl
from cstone_tpu_torch.ops import neighbors_v1, stencil
from cstone_tpu_torch.ops.keys64 import to_numpy, usort
from cstone_tpu_torch.sfc import compute_sfc_keys, make_box
from cstone_tpu_torch.traversal import celllist as tcl
from cstone_tpu_torch.utils.workloads import cell_rows, dense_groups, wrap_threshold_ell

import torch_threads  # noqa: F401  (two intra-op threads per xdist worker)

ROWS = (0, 1, 32, 33, 64)


# each case compiles JAX's cell list once (about 3 s): two cases cover both
# levels and both boundary kinds
@pytest.mark.parametrize("level,periodic", [(2, False), (3, True)])
def test_asym_plain_on_cell_rows_matches_jax_xla(level, periodic):
    pos, h = cell_rows(level, ROWS, seed=level)
    tbox = make_box(0.0, 1.0, boundaries=int(periodic), device="cpu")
    p = torch.from_numpy(pos)
    keys, order = usort(compute_sfc_keys(p[:, 0], p[:, 1], p[:, 2], tbox, np.uint64))
    cols = tuple(torch.from_numpy(np.ascontiguousarray(a))[order]
                 for a in (pos[:, 0], pos[:, 1], pos[:, 2], h))
    perm, _ = tcl.rowmajor_cell_perm(level, device="cpu")
    _, valid, _, _ = tcl.ell_pack_gather(keys, perm, cols, 64, level)
    assert set(valid.sum(dim=1).tolist()) == set(ROWS)
    tc, tovf = tcl.cell_list_neighbor_counts(keys, *cols, tbox, level, 64, impl="pallas_asym")
    jbox = jax_make_box(0.0, 1.0, boundaries=int(periodic))
    jcounts = jax.jit(jcl.cell_list_neighbor_counts, static_argnames=("level", "cap", "impl"))
    jc, jovf = jcounts(jnp.asarray(to_numpy(keys)), *(jnp.asarray(c.numpy()) for c in cols), jbox,
                       level=level, cap=64, impl="xla")
    assert not bool(tovf) and not bool(jovf)
    assert int(tc.sum()) > 0
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_asym_plain_on_wrap_pairs_matches_jax(axis):
    # one end counts the other, the other does not: a reused d2 would flip one
    planes, valid, level, _, _ = wrap_threshold_ell(axis)
    px, py, pz, r2 = torch.from_numpy(planes)
    got = stencil.stencil_counts_asym_plain(px, py, pz, r2, torch.from_numpy(valid), torch.ones(3),
                                            (True,) * 3, level)
    jstencil = jax.jit(jcl.stencil_neighbor_counts, static_argnames=("level",))
    want = jstencil(*(jnp.asarray(a) for a in planes), jnp.asarray(valid),
                    jax_make_box(0.0, 1.0, boundaries=1), level=level)
    assert int(got.sum()) == 1
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("G", [1, 33, 256, 1024])
def test_dense_plain_on_edge_groups_matches_jax(G):
    targets, r2, cand, cidx = dense_groups(G, n_groups=8, n_cand=300, seed=G)
    got = neighbors_v1.pairwise_count(*(torch.from_numpy(a) for a in (targets, r2, cand, cidx)))
    want = jax_pairwise_count(*(jnp.asarray(a) for a in (targets, r2, cand, cidx)), interpret=True)
    np.testing.assert_array_equal(got.numpy().astype(np.int64), np.asarray(want).astype(np.int64))
    assert int(got[1].sum()) == 0 and int(got[r2 < 0].sum()) == 0
    assert int(got.sum()) > 0
