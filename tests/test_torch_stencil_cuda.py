"""The hand-written CUDA stencil kernel (cstone_tpu_torch/csrc/stencil.cu)
against its plain PyTorch versions, on the card: B1/B2 (self-excluded
counts and density), B1 at caps above 1024, B3 (cross pass between two
disjoint sets, both legs) and B4 (the one-sided route, against
impl="xla"), and every B1 and B3 launch of the tiered cell list on
the arguments it made them with. Skips without an NVIDIA GPU and nvcc; chip_smoke.py phase 3
runs the same checks. Tolerance: counts bit-equal, density sums within
rtol 1e-5 (summation order differs)."""

import numpy as np
import pytest
import torch

from cstone_tpu_torch.ops import stencil
from cstone_tpu_torch.ops.cuda_lib import nvcc_path, record_launches
from cstone_tpu_torch.ops.keys64 import srl, usort
from cstone_tpu_torch.sfc import compute_sfc_keys, make_box
from cstone_tpu_torch.traversal import celllist, tiered
from cstone_tpu_torch.utils.workloads import adaptive_h, gaussian_coords

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    try:
        nvcc_path()
    except RuntimeError:
        pytest.skip("needs an NVIDIA GPU and nvcc")
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


def _sorted_sample(dev, n, periodic, gauss, seed, level):
    rng = np.random.RandomState(seed)
    if gauss:
        pos = gaussian_coords(n, (0.0, 1.0) * 3, seed=seed)
    else:
        pos = rng.uniform(0.0, 1.0, size=(n, 3)).astype(np.float32)
    pos = torch.from_numpy(pos).to(dev)
    h = torch.from_numpy(rng.uniform(0.3, 0.5, n).astype(np.float32)).to(dev) / (1 << level)
    m = torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32)).to(dev)
    box = make_box(0.0, 1.0, boundaries=int(periodic), device=dev)
    keys, order = usort(compute_sfc_keys(pos[:, 0], pos[:, 1], pos[:, 2], box, np.uint64))
    cols = tuple(c[order].contiguous() for c in (pos[:, 0], pos[:, 1], pos[:, 2], h, m))
    return keys, cols, box


def _pack(keys, cols, level, cap):
    perm, _ = celllist.rowmajor_cell_perm(level, device=keys.device)
    (px, py, pz, ph, pm), valid, _, ovf = celllist.ell_pack(keys, perm, cols, cap, level)
    assert not bool(ovf)
    return px, py, pz, ph, torch.where(valid, pm, 0.0), valid


def _ell(dev, level, periodic, gauss, seed=0, cap=64, n=None):
    # default sizes keep the fullest cell below cap 64 (Gaussian sigma = 0.2)
    n = n or (2500 if level == 3 else 150_000)
    keys, cols, box = _sorted_sample(dev, n, periodic, gauss, seed, level)
    return _pack(keys, cols, level, cap) + (box,)


def _r2(ph, valid):
    return torch.where(valid, (2.0 * ph) * (2.0 * ph), -1.0)


@pytest.mark.parametrize("level", [3, 5])
@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("gauss", [False, True])
def test_kernel_matches_plain(cuda_device, level, periodic, gauss):
    px, py, pz, ph, pm, valid, box = _ell(cuda_device, level, periodic, gauss)
    flags = (periodic,) * 3
    r2 = _r2(ph, valid)
    got = stencil.stencil_counts(px, py, pz, r2, valid, box.lengths, flags, level)
    want = stencil.stencil_counts_plain(px, py, pz, r2, valid, box.lengths, flags, level)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    for mass in (None, pm):
        got = stencil.stencil_density(px, py, pz, ph, valid, box.lengths, flags, level, mass)
        want = stencil.stencil_density_plain(px, py, pz, ph, valid, box.lengths, flags, level, mass)
        torch.cuda.synchronize()
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-5, atol=1e-6)


# level 2, Gaussian: the densest of the 64 cells holds 1060 (n 16,500) and
# 2284 (n 35,000) particles, more than the 1024 threads a block may have
@pytest.mark.parametrize("cap,n", [(1088, 16_500), (2496, 35_000)])
@pytest.mark.parametrize("periodic", [False, True])
def test_large_cap_matches_plain(cuda_device, cap, n, periodic):
    px, py, pz, ph, pm, valid, box = _ell(cuda_device, 2, periodic, True, seed=7, cap=cap, n=n)
    assert int(valid.sum(dim=1).max()) > 1024
    flags = (periodic,) * 3
    r2 = _r2(ph, valid)
    got = stencil.stencil_counts(px, py, pz, r2, valid, box.lengths, flags, 2)
    want = stencil.stencil_counts_plain(px, py, pz, r2, valid, box.lengths, flags, 2)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    got = stencil.stencil_density(px, py, pz, ph, valid, box.lengths, flags, 2, pm)
    want = stencil.stencil_density_plain(px, py, pz, ph, valid, box.lengths, flags, 2, pm)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-5, atol=1e-6)


def cross_tables(dev, level, periodic, op, n=6000, seed=3):
    """Two disjoint sets of one Gaussian sample packed at `level` with
    unequal caps (A: the dense 70%, B: the rest): ((x, y, z, w, valid),
    mass) for each, w = r2 (count) or h (density)."""
    keys, cols, box = _sorted_sample(dev, n, periodic, True, seed, level)
    in_b = torch.from_numpy(np.random.RandomState(seed).uniform(size=n) < 0.3).to(dev)
    tables = []
    for sel, extra in ((~in_b, 64), (in_b, 0)):
        occ = torch.bincount(srl(keys[sel], 3 * (21 - level))).max()
        cap = 64 * -(-int(occ) // 64) + extra
        px, py, pz, ph, pm, valid = _pack(keys[sel], tuple(c[sel] for c in cols), level, cap)
        w = _r2(ph, valid) if op == "count" else ph
        tables.append(((px, py, pz, w, valid), pm))
    return tables, box


@pytest.mark.parametrize("level", [2, 3])
@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("op", ["count", "density"])
def test_cross_matches_plain(cuda_device, level, periodic, op):
    ((ta, ma), (tb, mb)), box = cross_tables(cuda_device, level, periodic, op)
    assert ta[0].shape[1] != tb[0].shape[1]
    flags = (periodic,) * 3
    mass = dict(mass_t=ma, mass_c=mb) if op == "density" else {}
    got = stencil.stencil_cross(ta, tb, box.lengths, flags, level, op=op, **mass)
    want = stencil.stencil_cross_plain(ta, tb, box.lengths, flags, level, op=op, **mass)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        if op == "count":
            assert torch.equal(g, w)
        else:
            np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("level", [3, 5])
@pytest.mark.parametrize("periodic", [False, True])
def test_asym_matches_xla(cuda_device, level, periodic):
    px, py, pz, ph, _, valid, box = _ell(cuda_device, level, periodic, True, seed=5)
    flags = (periodic,) * 3
    r2 = _r2(ph, valid)
    got = stencil.stencil_counts_asym(px, py, pz, r2, valid, box.lengths, flags, level)
    want = stencil.stencil_counts_plain(px, py, pz, r2, valid, box.lengths, flags, level)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("periodic", [False, True])
def test_tiered_launches_match_plain(cuda_device, periodic):
    # 50K Gaussian particles with adaptive h span tiers at levels (4, 5)
    pos = gaussian_coords(50_000, (0.0, 1.0) * 3, seed=42)
    h_np = adaptive_h(pos, (0.0, 1.0) * 3, 100.0)
    levels = tiered.choose_tier_levels(h_np, 1.0, max_tiers=3)
    assert len(levels) == 2
    caps, cross = tiered.tier_caps(pos, h_np, (0.0, 1.0), levels, slack=1.3)
    box = make_box(0.0, 1.0, boundaries=int(periodic), device=cuda_device)
    p = torch.from_numpy(pos).to(cuda_device)
    keys, order = usort(compute_sfc_keys(p[:, 0], p[:, 1], p[:, 2], box, np.uint64))
    h = torch.from_numpy(h_np).to(cuda_device)
    cols = tuple(c[order].contiguous() for c in (p[:, 0], p[:, 1], p[:, 2], h))
    with record_launches() as calls:
        _, ovf = tiered.cell_list_neighbor_counts_tiered(keys, *cols, box, levels, caps, cross)
    assert not bool(ovf)
    assert sorted(name for name, _, _ in calls) == ["stencil_counts"] * 2 + ["stencil_cross"]
    for name, args, got in calls:
        want = getattr(stencil, name + "_plain")(*args)
        torch.cuda.synchronize()
        got, want = (got, want) if name == "stencil_cross" else ((got,), (want,))
        assert all(torch.equal(g, w) for g, w in zip(got, want))
