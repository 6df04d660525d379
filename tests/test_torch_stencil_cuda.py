"""The hand-written CUDA stencil kernel (cstone_tpu_torch/csrc/stencil.cu)
against its plain PyTorch version, on the card. Skips without an NVIDIA
GPU and nvcc; chip_smoke.py phase 3 is the same check at the main path's
shapes. Tolerance: counts bit-equal, density sums within rtol 1e-5
(summation order differs)."""

import numpy as np
import pytest
import torch

from cstone_tpu_torch.ops import stencil
from cstone_tpu_torch.ops.keys64 import usort
from cstone_tpu_torch.sfc import compute_sfc_keys, make_box
from cstone_tpu_torch.traversal import celllist
from cstone_tpu_torch.utils.workloads import gaussian_coords

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    try:
        stencil.nvcc_path()
    except RuntimeError:
        pytest.skip("needs an NVIDIA GPU and nvcc")
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


def _ell(dev, level, periodic, gauss, seed=0, cap=64):
    # sizes keep the fullest cell below cap (Gaussian sigma = 0.2)
    n = 2500 if level == 3 else 150_000
    rng = np.random.RandomState(seed)
    if gauss:
        pos = gaussian_coords(n, (0.0, 1.0) * 3, seed=seed)
    else:
        pos = rng.uniform(0.0, 1.0, size=(n, 3)).astype(np.float32)
    pos = torch.from_numpy(pos).to(dev)
    h = torch.from_numpy(rng.uniform(0.3, 0.5, n).astype(np.float32)).to(dev) / (1 << level)
    box = make_box(0.0, 1.0, boundaries=int(periodic), device=dev)
    keys = compute_sfc_keys(pos[:, 0], pos[:, 1], pos[:, 2], box, np.uint64)
    keys, order = usort(keys)
    cols = tuple(c[order].contiguous() for c in (pos[:, 0], pos[:, 1], pos[:, 2], h))
    perm, _ = celllist.rowmajor_cell_perm(level, device=dev)
    m = torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32)).to(dev)[order]
    (px, py, pz, ph, pm), valid, _, ovf = celllist.ell_pack(keys, perm, cols + (m,), cap, level)
    return px, py, pz, ph, torch.where(valid, pm, 0.0), valid, box, bool(ovf)


@pytest.mark.parametrize("level", [3, 5])
@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("gauss", [False, True])
def test_kernel_matches_plain(cuda_device, level, periodic, gauss):
    px, py, pz, ph, pm, valid, box, ovf = _ell(cuda_device, level, periodic, gauss)
    assert not ovf
    flags = (periodic,) * 3
    r2 = torch.where(valid, (2.0 * ph) * (2.0 * ph), -1.0)
    got = stencil.stencil_counts(px, py, pz, r2, valid, box.lengths, flags, level)
    want = stencil.stencil_counts_plain(px, py, pz, r2, valid, box.lengths, flags, level)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    for mass in (None, pm):
        got = stencil.stencil_density(px, py, pz, ph, valid, box.lengths, flags, level, mass)
        want = stencil.stencil_density_plain(px, py, pz, ph, valid, box.lengths, flags, level, mass)
        torch.cuda.synchronize()
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-5, atol=1e-6)
