"""The symmetric cross pass of kernel B3 (csrc/stencil_sym.cu), checked on
the CPU through its plain mirror `stencil_cross_sym_plain`: each A-B pair
of two disjoint tables tested once over the 27 cells around each cell of
the lane table (the table `cross_lanes_on_b` picks), both ends credited,
the staged end taking d2 from its own end across a periodic wrap. It must
equal the two one-sided passes of `stencil_cross_plain`.

Tolerances: counts bit-equal; density sums within rtol 1e-5 / atol 1e-6
(the summation order differs)."""

import numpy as np
import pytest
import torch

from cstone_tpu_torch.ops import stencil
from cstone_tpu_torch.ops.keys64 import srl, usort
from cstone_tpu_torch.sfc import compute_sfc_keys, make_box
from cstone_tpu_torch.traversal import celllist
from cstone_tpu_torch.utils.workloads import gaussian_coords, wrap_threshold_cross

import torch_threads  # noqa: F401  (two intra-op threads per xdist worker)


def _cross_tables(n, level, periodic, op, seed=3):
    """Two disjoint sets of one Gaussian sample at `level` with unequal caps
    (A: the 70% share, cap + 8; B: the rest): ((x, y, z, w, valid), mass)
    for each, w = r2 (count) or h (density), h in [0.3, 0.5] cell sides."""
    rng = np.random.RandomState(seed)
    pos = torch.from_numpy(gaussian_coords(n, (0.0, 1.0) * 3, seed=seed))
    h = torch.from_numpy(rng.uniform(0.3, 0.5, n).astype(np.float32)) / (1 << level)
    m = torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32))
    box = make_box(0.0, 1.0, boundaries=int(periodic), device="cpu")
    keys, order = usort(compute_sfc_keys(pos[:, 0], pos[:, 1], pos[:, 2], box, np.uint64))
    cols = tuple(c[order].contiguous() for c in (pos[:, 0], pos[:, 1], pos[:, 2], h, m))
    in_b = torch.from_numpy(rng.uniform(size=n) < 0.3)
    perm, _ = celllist.rowmajor_cell_perm(level, device="cpu")
    tables = []
    for sel, extra in ((~in_b, 8), (in_b, 0)):
        occ = int(torch.bincount(srl(keys[sel], 3 * (21 - level))).max())
        cap = 8 * -(-occ // 8) + extra
        (px, py, pz, ph, pm), valid, _, ovf = celllist.ell_pack_gather(
            keys[sel], perm, tuple(c[sel] for c in cols), cap, level)
        assert not bool(ovf)
        w = torch.where(valid, (2.0 * ph) * (2.0 * ph), -1.0) if op == "count" else ph
        tables.append(((px, py, pz, w, valid), torch.where(valid, pm, 0.0)))
    return tables, box


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("op,with_mass", [("count", False), ("density", False), ("density", True)])
def test_cross_sym_plain_equals_two_one_sided_passes(periodic, op, with_mass):
    ((ta, ma), (tb, mb)), box = _cross_tables(3000, 3, periodic, op)
    assert ta[0].shape[1] != tb[0].shape[1]
    flags = (periodic,) * 3
    mass = dict(mass_t=ma, mass_c=mb) if with_mass else {}
    want = stencil.stencil_cross_plain(ta, tb, box.lengths, flags, 3, op, **mass)
    got = stencil.stencil_cross_sym_plain(ta, tb, box.lengths, flags, 3, op, **mass)
    for g, w, t in zip(got, want, (ta, tb)):
        assert g.shape == t[0].shape
        assert float(w.sum()) > 0
        if op == "count":
            assert torch.equal(g, w)
        else:
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5, atol=1e-6)
    # on the CPU the wrapper runs the two-pass plain version
    for g, w in zip(stencil.stencil_cross(ta, tb, box.lengths, flags, 3, op, **mass), want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("swap", [False, True])
def test_cross_wrap_pair_uses_each_ends_own_d2(axis, swap):
    planes, valid_a, valid_b, level, d2_a, d2_b = wrap_threshold_cross(axis, swap)
    px, py, pz, r2 = torch.from_numpy(planes)
    ta, tb = ((px, py, pz, r2, torch.from_numpy(v)) for v in (valid_a, valid_b))
    radius2 = max(d2_a, d2_b)
    # the two ends decide differently, so a d2 reused from either end
    # flips one of them
    assert (d2_a < radius2) != (d2_b < radius2)
    L, flags = torch.ones(3), (True,) * 3
    want = stencil.stencil_cross_plain(ta, tb, L, flags, level)
    assert [int(w.sum()) for w in want] == [int(d2_a < radius2), int(d2_b < radius2)]
    got = stencil.stencil_cross_sym_plain(ta, tb, L, flags, level)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("periodic", [False, True])
def test_cross_sym_plain_lanes_on_either_table(periodic):
    # A holds 70% of the sample: its busy chunks are the fuller ones, so
    # the lanes go on A, and on it again when it is passed second
    ((ta, _), (tb, _)), box = _cross_tables(3000, 3, periodic, "count")
    assert not stencil.cross_lanes_on_b(ta[4], tb[4])
    assert stencil.cross_lanes_on_b(tb[4], ta[4])
    assert not stencil.cross_lanes_on_b(torch.zeros_like(tb[4]), ta[4])
    flags = (periodic,) * 3
    for t1, t2 in ((ta, tb), (tb, ta)):
        want = stencil.stencil_cross_plain(t1, t2, box.lengths, flags, 3)
        got = stencil.stencil_cross_sym_plain(t1, t2, box.lengths, flags, 3)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
