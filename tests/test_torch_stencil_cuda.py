"""The hand-written CUDA stencil kernels against their plain PyTorch
versions, on the card: B1/B2 (self-excluded counts and density, the
half-stencil kernel csrc/stencil_sym.cu) on uniform and Gaussian grids, at
caps above 1024, across a periodic wrap whose d2 differs between the two
ends, and launch to launch; B3 (the cross pass between two disjoint sets,
one symmetric launch of csrc/stencil_sym.cu for both sides) with unequal
caps, a lane-table cap above 1024 with the lanes on either argument, and
the wrap pair split across the two tables; B4 (the one-sided mode of
csrc/stencil_sym.cu) against impl="xla" and against its plain version on
rows of 0/1/32/33/64 slots at levels 2-5, periodic and open, at caps above
1024 and on the wrap pairs; every B1 and B3 launch of the tiered cell list on the arguments it made
them with; and the SPH density cell's pass (B2 with per-particle masses
at level 5, cap 128, 2M particles) within the benchmark's bound of its
plain reference. Skips without an NVIDIA GPU and nvcc; chip_smoke.py
phase 3 runs the same checks. Tolerance: counts bit-equal, density sums
within rtol 1e-5 (summation order differs, and varies from launch to
launch)."""

import numpy as np
import pytest
import torch

from cstone_tpu_torch.ops import stencil
from cstone_tpu_torch.ops.cuda_lib import nvcc_path, record_launches
from cstone_tpu_torch.ops.keys64 import srl, usort
from cstone_tpu_torch.sfc import compute_sfc_keys, make_box
from cstone_tpu_torch.traversal import celllist, tiered
from cstone_tpu_torch.utils.workloads import (
    adaptive_h,
    cell_rows,
    gaussian_coords,
    wrap_threshold_cross,
    wrap_threshold_ell,
)

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
    (px, py, pz, ph, pm), valid, _, ovf = celllist.ell_pack_gather(keys, perm, cols, cap, level)
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


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_wrap_pair_matches_plain(cuda_device, axis):
    # the candidate end must test its own d2 across the wrap (a reused d2
    # flips this pair's count at one end)
    planes, valid, level, _, _ = wrap_threshold_ell(axis)
    px, py, pz, r2 = torch.from_numpy(planes).to(cuda_device)
    valid = torch.from_numpy(valid).to(cuda_device)
    L = torch.ones(3, device=cuda_device)
    flags = (True,) * 3
    got = stencil.stencil_counts(px, py, pz, r2, valid, L, flags, level)
    want = stencil.stencil_counts_plain(px, py, pz, r2, valid, L, flags, level)
    torch.cuda.synchronize()
    assert int(want.sum()) == 1
    assert torch.equal(got, want)


def test_launches_repeat(cuda_device):
    # integer atomics: counts identical launch to launch; float atomics:
    # density sums agree within rtol 1e-5
    px, py, pz, ph, pm, valid, box = _ell(cuda_device, 5, True, True, seed=3)
    flags = (True,) * 3
    r2 = _r2(ph, valid)
    a, b = (stencil.stencil_counts(px, py, pz, r2, valid, box.lengths, flags, 5) for _ in range(2))
    da, db = (stencil.stencil_density(px, py, pz, ph, valid, box.lengths, flags, 5, pm)
              for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    np.testing.assert_allclose(da.cpu().numpy(), db.cpu().numpy(), rtol=1e-5, atol=1e-6)


def test_density_with_masses_within_the_reference_bound(cuda_device):
    """The pass of the cell uniform-2M.density: cell_list_sph_density at
    level 5 and cap 128 on 2M uniform particles with per-particle masses
    (h 0.009-0.0125, masses uniform in [0.5, 1.5] / n): one B2 launch a
    call (trace counter `density.kernel` 1, `density.plain` 0), and every
    density within the benchmark's written bound of its plain reference
    (benchmark/reference/compare_density.py, density.py)."""
    from benchmark.reference.compare_density import density_bound, density_faults
    from benchmark.reference.density import sph_density as reference_density
    from cstone_tpu_torch.utils import trace

    n, level, cap = 2_000_000, 5, 128
    rng = np.random.RandomState(23)
    pos = rng.uniform(0.0, 1.0, size=(3, n)).astype(np.float32)
    h = rng.uniform(0.009, 0.0125, n).astype(np.float32)
    m = rng.uniform(0.5, 1.5, n).astype(np.float32) / n
    x, y, z, h, m = (torch.from_numpy(np.ascontiguousarray(a)).to(cuda_device) for a in (*pos, h, m))
    box = make_box(0.0, 1.0, boundaries=1, device=cuda_device)
    keys, order = usort(compute_sfc_keys(x, y, z, box, np.uint64))
    cols = tuple(c[order].contiguous() for c in (x, y, z, h, m))
    before = stencil.launches()["stencil_density"]
    with trace.collect() as tally:
        rho, ovf = celllist.cell_list_sph_density(keys, *cols[:4], box, level, cap, mass=cols[4])
    torch.cuda.synchronize()
    assert not bool(ovf)
    assert tally.read()["counts"] == {"density.kernel": 1}
    assert stencil.launches()["stencil_density"] == before + 1
    ref, near, _ = reference_density(*cols, 0.0, 1.0)
    assert float(near.double().mean()) > 50.0
    worst = float(((rho.double() - ref.double()).abs() / density_bound(ref, near)).max())
    print(f"the densities' largest gap from the reference: {worst:.4g} of the bound")
    assert int(density_faults(rho, ref, near).sum()) == 0, worst


def cross_tables(dev, level, periodic, op, n=6000, seed=3, frac_b=0.3):
    """Two disjoint sets of one Gaussian sample packed at `level` with
    unequal caps (B: a share frac_b of the particles, A: the rest):
    ((x, y, z, w, valid), mass) for each, w = r2 (count) or h (density)."""
    keys, cols, box = _sorted_sample(dev, n, periodic, True, seed, level)
    in_b = torch.from_numpy(np.random.RandomState(seed).uniform(size=n) < frac_b).to(dev)
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
    assert not stencil.cross_lanes_on_b(ta[4], tb[4])  # A, the 70% share, takes the lanes
    flags = (periodic,) * 3
    mass = dict(mass_t=ma, mass_c=mb) if op == "density" else {}
    stencil.reset_launches()
    got = stencil.stencil_cross(ta, tb, box.lengths, flags, level, op=op, **mass)
    assert stencil.launches()["stencil_cross"] == 1
    want = stencil.stencil_cross_plain(ta, tb, box.lengths, flags, level, op=op, **mass)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        if op == "count":
            assert torch.equal(g, w)
        else:
            np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=1e-5, atol=1e-6)


# level 2: B holds 70% of 35,000 Gaussian particles, about 1,600 in its
# densest cell, and takes the kernel's lanes; passed first, it takes them
# again, so the lane table is in turn each argument
@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("op", ["count", "density"])
def test_cross_large_lane_cap_matches_plain(cuda_device, periodic, op):
    ((ta, ma), (tb, mb)), box = cross_tables(cuda_device, 2, periodic, op, n=35_000, frac_b=0.7)
    assert int(tb[4].sum(dim=1).max()) > 1024
    assert stencil.cross_lanes_on_b(ta[4], tb[4])
    flags = (periodic,) * 3
    for (t1, m1), (t2, m2) in (((ta, ma), (tb, mb)), ((tb, mb), (ta, ma))):
        mass = dict(mass_t=m1, mass_c=m2) if op == "density" else {}
        got = stencil.stencil_cross(t1, t2, box.lengths, flags, 2, op=op, **mass)
        want = stencil.stencil_cross_plain(t1, t2, box.lengths, flags, 2, op=op, **mass)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            if op == "count":
                assert torch.equal(g, w)
            else:
                np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("swap", [False, True])
def test_cross_wrap_pair_matches_plain(cuda_device, axis, swap):
    # the staged end must test its own d2 across the wrap; with swap the
    # counting end is in turn the lane end and the staged end
    planes, valid_a, valid_b, level, _, _ = wrap_threshold_cross(axis, swap)
    px, py, pz, r2 = torch.from_numpy(planes).to(cuda_device)
    ta, tb = ((px, py, pz, r2, torch.from_numpy(v).to(cuda_device)) for v in (valid_a, valid_b))
    L, flags = torch.ones(3, device=cuda_device), (True,) * 3
    got = stencil.stencil_cross(ta, tb, L, flags, level)
    want = stencil.stencil_cross_plain(ta, tb, L, flags, level)
    torch.cuda.synchronize()
    assert sum(int(w.sum()) for w in want) == 1
    assert all(torch.equal(g, w) for g, w in zip(got, want))


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


@pytest.mark.parametrize("level", [2, 3, 4, 5])
@pytest.mark.parametrize("periodic", [False, True])
def test_asym_on_cell_rows_matches_plain(cuda_device, level, periodic):
    # rows of 0, 1, 32, 33 and 64 valid slots: before, at and past a chunk edge
    pos, h = cell_rows(level, seed=level)
    p = torch.from_numpy(pos).to(cuda_device)
    box = make_box(0.0, 1.0, boundaries=int(periodic), device=cuda_device)
    keys, order = usort(compute_sfc_keys(p[:, 0], p[:, 1], p[:, 2], box, np.uint64))
    cols = tuple(c[order].contiguous() for c in (p[:, 0], p[:, 1], p[:, 2],
                                                 torch.from_numpy(h).to(cuda_device)))
    perm, _ = celllist.rowmajor_cell_perm(level, device=cuda_device)
    (px, py, pz, ph), valid, _, ovf = celllist.ell_pack_gather(keys, perm, cols, 64, level)
    assert not bool(ovf)
    assert set(valid.sum(dim=1).tolist()) == {0, 1, 32, 33, 64}
    flags, r2 = (periodic,) * 3, _r2(ph, valid)
    got = stencil.stencil_counts_asym(px, py, pz, r2, valid, box.lengths, flags, level)
    want = stencil.stencil_counts_asym_plain(px, py, pz, r2, valid, box.lengths, flags, level)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("cap,n", [(1088, 16_500), (2496, 35_000)])
@pytest.mark.parametrize("periodic", [False, True])
def test_asym_large_cap_matches_plain(cuda_device, cap, n, periodic):
    px, py, pz, ph, _, valid, box = _ell(cuda_device, 2, periodic, True, seed=7, cap=cap, n=n)
    assert int(valid.sum(dim=1).max()) > 1024
    flags, r2 = (periodic,) * 3, _r2(ph, valid)
    got = stencil.stencil_counts_asym(px, py, pz, r2, valid, box.lengths, flags, 2)
    want = stencil.stencil_counts_asym_plain(px, py, pz, r2, valid, box.lengths, flags, 2)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_asym_wrap_pair_matches_plain(cuda_device, axis):
    # the staged slot is shifted by o L, as the plain version shifts it
    planes, valid, level, _, _ = wrap_threshold_ell(axis)
    px, py, pz, r2 = torch.from_numpy(planes).to(cuda_device)
    valid, L = torch.from_numpy(valid).to(cuda_device), torch.ones(3, device=cuda_device)
    got = stencil.stencil_counts_asym(px, py, pz, r2, valid, L, (True,) * 3, level)
    want = stencil.stencil_counts_asym_plain(px, py, pz, r2, valid, L, (True,) * 3, level)
    torch.cuda.synchronize()
    assert int(want.sum()) == 1
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
