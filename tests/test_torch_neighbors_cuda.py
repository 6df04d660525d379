"""The hand-written CUDA neighbor kernels against their plain PyTorch
versions, on the card: B5 (csrc/neighbors_v2.cu, run streaming, the
"v2" route of find_neighbors) and B6 (csrc/neighbors_v1.cu, dense over
pre-gathered candidates, the "v1" route), on the arguments find_neighbors
launches them with after Domain.sync for 16K uniform and Gaussian particles with the
group settings of test_neighbors.py; B5 also on tiles that need no
image, one hoisted shift or the per-pair image (mixed_image_runs); B6
also on groups of 1, 33, 256 and 1024 targets over candidate counts that
are no multiple of its tile, with empty groups, holes of -1 slots, a
target's own index at tile edges and targets with r2 < 0
(dense_groups); B5's list mode (the default route for index lists on
the card) on find_neighbors' arguments with rows that overflow ng_max
and on the mixed-image tiles. Skips without an NVIDIA GPU and nvcc;
chip_smoke.py phases 3 and 6 run the same checks. Tolerance: counts and
lists bit-equal."""

import numpy as np
import pytest
import torch

from cstone_tpu_torch.domain import Domain
from cstone_tpu_torch.ops import neighbors_v1, neighbors_v2
from cstone_tpu_torch.ops.cuda_lib import nvcc_path, record_launches
from cstone_tpu_torch.sfc import make_box
from cstone_tpu_torch.traversal import neighbors
from cstone_tpu_torch.utils.workloads import dense_groups, gaussian_coords, mixed_image_runs

pytestmark = pytest.mark.cuda

# the group settings of test_neighbors.py
KW = dict(group_size=32, cand_cap=8192, cand_leaf_cap=640)


@pytest.fixture
def cuda_device():
    try:
        nvcc_path()
    except RuntimeError:
        pytest.skip("needs an NVIDIA GPU and nvcc")
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


def synced_view(dev, n, periodic, gauss, seed=11, bucket=16):
    """Domain.sync of n particles in the unit box -> (x, y, z, h, view,
    box), h uniform in [0.01, 0.03] (about 4-40 neighbours at 16K)."""
    rng = np.random.RandomState(seed)
    if gauss:
        pos = gaussian_coords(n, (0.0, 1.0) * 3, seed=seed)
    else:
        pos = rng.uniform(0.0, 1.0, size=(n, 3)).astype(np.float32)
    h = rng.uniform(0.01, 0.03, size=n).astype(np.float32)
    box = make_box(0.0, 1.0, boundaries=int(periodic), device=dev)
    domain = Domain(bucket_size=bucket, tree_capacity=max(1024, 4 * n // bucket), device=dev)
    state = domain.init_state(box=box, boundaries=(int(periodic),) * 3)
    cols = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (pos[:, 0], pos[:, 1], pos[:, 2], h)]
    state, res = domain.sync(state, *cols)
    assert int(res.overflow) == 0
    return res.x, res.y, res.z, res.h, domain.ns_view(res, state.box), state.box


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("gauss", [False, True])
def test_runs_kernel_matches_plain(cuda_device, periodic, gauss):
    x, y, z, h, view, box = synced_view(cuda_device, 16384, periodic, gauss)
    with record_launches() as calls:
        counts, _ = neighbors.find_neighbors(x, y, z, h, view, box, use_pallas="v2", **KW)
    [(name, args, got)] = calls
    assert name == "pairwise_count_runs"
    want = neighbors_v2.pairwise_count_runs_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(counts[:16384], got.reshape(-1)[:16384])


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("gauss", [False, True])
def test_dense_kernel_matches_plain(cuda_device, periodic, gauss):
    x, y, z, h, view, box = synced_view(cuda_device, 16384, periodic, gauss)
    with record_launches() as calls:
        counts, _ = neighbors.find_neighbors(x, y, z, h, view, box, use_pallas="v1", **KW)
    [(name, args, got)] = calls
    assert name == "pairwise_count"
    assert torch.equal(counts[:16384], got.reshape(-1)[:16384])
    want = neighbors_v1.pairwise_count_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("G,n_groups", [(32, 48), (256, 12)])
@pytest.mark.parametrize("periodic", [False, True])
def test_runs_kernel_mixed_images(cuda_device, G, n_groups, periodic):
    args = tuple(torch.from_numpy(a).to(cuda_device) for a in mixed_image_runs(G, n_groups, periodic))
    got = neighbors_v2.pairwise_count_runs(*args)
    want = neighbors_v2.pairwise_count_runs_plain(*args)
    torch.cuda.synchronize()
    assert int(want.sum()) > 0
    assert torch.equal(got, want)


@pytest.mark.parametrize("G", [1, 33, 256, 1024])
@pytest.mark.parametrize("C", [300, 4133])
def test_dense_kernel_on_edge_groups(cuda_device, G, C):
    args = tuple(torch.from_numpy(a).to(cuda_device) for a in dense_groups(G, 8, C, seed=G + C))
    got = neighbors_v1.pairwise_count(*args)
    want = neighbors_v1.pairwise_count_plain(*args)
    torch.cuda.synchronize()
    assert int(want.sum()) > 0 and int(want[1].sum()) == 0
    assert torch.equal(got, want)


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("gauss", [False, True])
def test_list_kernel_matches_plain(cuda_device, periodic, gauss):
    """find_neighbors with index lists on the default route: B5's list
    mode, bit-equal to its plain twin in counts and lists, with rows that
    overflow ng_max 12; its counts equal the count mode's."""
    x, y, z, h, view, box = synced_view(cuda_device, 16384, periodic, gauss)
    with record_launches() as calls:
        counts, lists = neighbors.find_neighbors(x, y, z, h, view, box, with_indices=True, ng_max=12, **KW)
    [(name, args, (got_counts, got_lists))] = calls
    assert name == "pairwise_list_runs"
    want_counts, want_lists = neighbors_v2.pairwise_list_runs_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got_counts, want_counts) and torch.equal(got_lists, want_lists)
    assert int((got_counts > 12).sum()) > 0
    assert torch.equal(got_counts, neighbors_v2.pairwise_count_runs(*args[:-1]))
    assert torch.equal(lists[:16384], got_lists.reshape(-1, 12)[:16384])
    assert torch.equal(counts[:16384], got_counts.reshape(-1)[:16384])


@pytest.mark.parametrize("G,n_groups", [(32, 48), (256, 12)])
@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("ng_max", [0, 5, 64])
def test_list_kernel_mixed_images(cuda_device, G, n_groups, periodic, ng_max):
    args = tuple(torch.from_numpy(a).to(cuda_device) for a in mixed_image_runs(G, n_groups, periodic))
    got = neighbors_v2.pairwise_list_runs(*args, ng_max)
    want = neighbors_v2.pairwise_list_runs_plain(*args, ng_max)
    torch.cuda.synchronize()
    assert int(want[0].sum()) > 0
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(got[0], neighbors_v2.pairwise_count_runs(*args))
