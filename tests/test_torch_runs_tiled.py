"""The per-tile minimum image of kernel B5 (csrc/neighbors_v2.cu), checked
on the CPU through its plain mirror `pairwise_count_runs_tiled_plain`:
floor(d / L + 1/2) is decided once per tile and axis from the extents of
the group's live targets and of the tile, and the self test runs only in
tiles that meet the group's own particles. The decision is exact, so the
mirror must equal the per-pair image of `pairwise_count_runs_plain` bit
for bit, on random runs, on tiles that need every kind of image, on pairs
at exactly +-L/2 and across each periodic face, and in the open box.

Tolerance: counts bit-equal."""

import numpy as np
import pytest
import torch

from cstone_tpu_torch.ops import neighbors_v2
from cstone_tpu_torch.utils.workloads import mixed_image_runs

import torch_threads  # noqa: F401  (two intra-op threads per xdist worker)


def _random_runs(n_groups, G, periodic, seed):
    """Uniform particles, each group's runs random ranges of them."""
    rng = np.random.RandomState(seed)
    n = n_groups * G
    pos = rng.uniform(0.0, 1.0, size=(n, 3)).astype(np.float32)
    start = rng.randint(0, n - 1, size=(n_groups, 5))
    length = np.minimum(rng.randint(0, 3 * G, size=(n_groups, 5)), n - start)
    r2 = rng.uniform(0.0, 0.2, size=(n_groups, G)).astype(np.float32)
    r2[rng.uniform(size=r2.shape) < 0.1] = -1.0
    box_params = np.array([1, 1, 1, 1, 1, 1] + [float(periodic)] * 3, np.float32)
    arrs = (pos.reshape(n_groups, G, 3), r2, start, length, pos[:, 0].copy(), pos[:, 1].copy(),
            pos[:, 2].copy(), box_params)
    return tuple(torch.from_numpy(a) for a in arrs)


def _kinds(args, tile):
    """Candidate slots in tiles with the per-pair image, with one nonzero
    hoisted shift, and in tiles that meet the group's own particles."""
    cidx, fixed, shift, own = neighbors_v2.tile_images(*args, tile=tile)
    ok = cidx >= 0
    each = ~fixed.all(dim=-1)
    shifted = fixed.all(dim=-1) & (shift != 0).any(dim=-1)
    return int((each & ok).sum()), int((shifted & ok).sum()), int((own & ok).sum())


@pytest.mark.parametrize("tile", [32, 256])
@pytest.mark.parametrize("periodic", [False, True])
def test_tiled_plain_equals_plain_on_random_runs(tile, periodic):
    args = _random_runs(16, 32, periodic, seed=5)
    want = neighbors_v2.pairwise_count_runs_plain(*args)
    assert int(want.sum()) > 0
    assert torch.equal(neighbors_v2.pairwise_count_runs_tiled_plain(*args, tile=tile), want)


@pytest.mark.parametrize("tile", [32, 256])
@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("G,n_groups", [(32, 24), (256, 9)])
def test_tiled_plain_equals_plain_on_mixed_images(tile, periodic, G, n_groups):
    args = tuple(torch.from_numpy(a) for a in mixed_image_runs(G, n_groups, periodic, seed=1))
    each, shifted, own = _kinds(args, tile)
    assert own > 0
    if periodic:  # tiles of all three kinds: no image, a hoisted shift, per pair
        assert each > 0 and shifted > 0
    else:
        assert each == shifted == 0
    want = neighbors_v2.pairwise_count_runs_plain(*args)
    assert torch.equal(neighbors_v2.pairwise_count_runs_tiled_plain(*args, tile=tile), want)


@pytest.mark.parametrize("tile", [32, 256])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_half_box_and_face_pairs(tile, axis):
    # targets on the 1/64 grid near one face; candidates the same points
    # at exactly +L/2 and mirrored onto the opposite face along `axis`,
    # radii just above (L/2)^2: every count hinges on the image
    rng = np.random.RandomState(axis)
    G = 32
    tgt = np.full((G, 3), 0.5, np.float32)
    tgt[:, axis] = rng.randint(0, 4, size=G) / np.float32(64.0)
    half = tgt.copy()
    half[:, axis] = tgt[:, axis] + np.float32(0.5)
    face = tgt.copy()
    face[:, axis] = np.float32(63.0 / 64.0) - tgt[:, axis]
    pos = np.concatenate([tgt, half, face])
    r2 = np.full((1, G), 0.25 + 1e-6, np.float32)
    runs = np.array([[0, 3 * G]])
    for periodic in (False, True):
        box_params = np.array([1, 1, 1, 1, 1, 1] + [float(periodic)] * 3, np.float32)
        args = tuple(torch.from_numpy(a) for a in (
            tgt[None], r2, runs[:, :1], runs[:, 1:], pos[:, 0].copy(), pos[:, 1].copy(),
            pos[:, 2].copy(), box_params))
        want = neighbors_v2.pairwise_count_runs_plain(*args)
        got = neighbors_v2.pairwise_count_runs_tiled_plain(*args, tile=tile)
        assert torch.equal(got, want)
        # each target sees its +L/2 image (d2 = 0.25 exactly) and, periodic,
        # the mirror points across the face within 4/64 of it
        assert bool((want >= 1).all())
