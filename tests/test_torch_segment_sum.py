"""ops.primitives.segment_sum, the sum over contiguous segments that
syncGrav's leaf centres (Domain.sync(grav=True), update_expansion_centers)
are made of, and fixed_point_segment_sum, its float32 route on the card.

- On the CPU segment_sum adds in index order: bit-equal to
  jax.ops.segment_sum with sorted indices over the JAX package's segment
  ids, on a leaf-like layout with empty segments and an offset past n.
- fixed_point_segment_sum (run here on CPU tensors; its arithmetic is
  integer and float64 scaling by powers of two, the same on every device):
  the same bits when each segment's values are shuffled, when zeros are
  put among them and when the other segments change; within one float32
  rounding of the float64 sum of each segment (rounded once); 0 for an
  empty segment; no int64 overflow at the largest values.
- On the card (marked cuda, skips without one): segment_sum on CUDA
  tensors equal, bit for bit and launch after launch, to
  fixed_point_segment_sum of the same values on the CPU, over shuffled
  segments. On the card's machine, which has no jax: `python -m pytest
  --noconftest -m cuda tests/test_torch_segment_sum.py`."""

import numpy as np
import pytest
import torch

from cstone_tpu_torch.ops.primitives import fixed_point_segment_sum, segment_ids_from_offsets, segment_sum


def _layout(seed, n=2000, n_seg=300):
    """Leaf-like values (w x, w y, w z, w) of clustered particles and
    sorted offsets with empty segments, the last one past n."""
    rng = np.random.RandomState(seed)
    w = rng.uniform(0.5, 1.5, size=(n, 1)).astype(np.float32)
    vals = np.concatenate([w * rng.normal(0, 0.25, size=(n, 3)).astype(np.float32), w], axis=1)
    offs = np.sort(rng.randint(0, n, size=n_seg + 1))
    offs[0], offs[-1] = 0, n + 7
    return vals, offs


def _shuffled_within(seg_id: torch.Tensor, seed: int) -> torch.Tensor:
    """A permutation of the elements that keeps each in its segment."""
    g = torch.Generator().manual_seed(seed)
    key = seg_id.double() + torch.rand(seg_id.shape[0], generator=g, dtype=torch.float64) * 0.5
    return torch.argsort(key)


@pytest.mark.parametrize("seed", [0, 1])
def test_cpu_route_is_jax_segment_sum(seed):
    # jax is imported here: the card's machine runs this file's cuda case
    # without it
    import jax
    import jax.numpy as jnp

    from cstone_tpu.ops.primitives import segment_ids_from_offsets as jax_segment_ids

    vals, offs = _layout(seed)
    n, n_seg = vals.shape[0], offs.shape[0] - 1
    got = segment_sum(torch.from_numpy(vals), torch.from_numpy(offs), n_seg)
    ids = jax_segment_ids(jnp.asarray(offs), n, n_seg)
    np.testing.assert_array_equal(segment_ids_from_offsets(torch.from_numpy(offs), n, n_seg).numpy(),
                                  np.asarray(ids))
    want = jax.ops.segment_sum(jnp.asarray(vals), ids, num_segments=n_seg, indices_are_sorted=True)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fixed_point_depends_on_the_segment_alone(seed):
    vals, offs = _layout(seed)
    n, n_seg = vals.shape[0], offs.shape[0] - 1
    v = torch.from_numpy(vals)
    seg = segment_ids_from_offsets(torch.from_numpy(offs), n, n_seg)
    base = fixed_point_segment_sum(v, seg, n_seg)
    # each segment shuffled
    p = _shuffled_within(seg, seed)
    assert torch.equal(fixed_point_segment_sum(v[p], seg[p], n_seg), base)
    # zeros among the values (a rank's halo slots masked out)
    zeros = torch.arange(n) % 3 == 1
    seg2 = torch.cat([seg, seg[zeros]])
    v2 = torch.cat([v, torch.zeros_like(v[zeros])])
    order = torch.argsort(seg2, stable=True)
    assert torch.equal(fixed_point_segment_sum(v2[order], seg2[order], n_seg), base)
    # the other segments scaled up: this one's bits stay
    far = seg != seg[n // 2]
    v3 = torch.where(far[:, None], v * 1024.0, v)
    assert torch.equal(fixed_point_segment_sum(v3, seg, n_seg)[seg[n // 2]], base[seg[n // 2]])
    # within one rounding of the float64 sum, rounded once
    exact = torch.zeros(n_seg, 4, dtype=torch.float64).index_add_(0, seg, v.double())
    ulp = torch.finfo(torch.float32).eps * exact.abs().float()
    assert bool(((base.double() - exact).abs() <= ulp.double()).all())
    empty = torch.ones(n_seg, dtype=torch.bool)
    empty[seg] = False
    assert bool(empty.any()) and bool((base[empty] == 0).all())


def test_fixed_point_holds_its_largest_values():
    # every value at the top of its scaled range, in one segment of 2^16:
    # the integer sum stays below 2^63 and the result is exact
    n = 1 << 16
    v = torch.full((n, 2), np.nextafter(np.float32(2.0), np.float32(0.0)), dtype=torch.float32)
    v[:, 1] = -3.0e30
    got = fixed_point_segment_sum(v, torch.zeros(n, dtype=torch.int64), 1)
    want = v.double().sum(dim=0).float()
    assert torch.equal(got[0], want)


@pytest.mark.cuda
def test_card_route_is_the_fixed_point_sum():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    vals, offs = _layout(3, n=400_000, n_seg=7000)
    n, n_seg = vals.shape[0], offs.shape[0] - 1
    v, o = torch.from_numpy(vals), torch.from_numpy(offs)
    seg = segment_ids_from_offsets(o, n, n_seg)
    want = fixed_point_segment_sum(v, seg, n_seg)
    dev = torch.device("cuda")
    for seed in range(4):
        p = _shuffled_within(seg, seed)
        got = segment_sum(v[p].to(dev), o.to(dev), n_seg)
        assert torch.equal(got.cpu(), want), seed
