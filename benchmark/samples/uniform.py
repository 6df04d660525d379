"""The uniform sample: bench.py's `sync_<n>_uniform` (cornerstone-octree
neighbor_driver.cu:175-195): positions uniform in the configuration's
cube, one radius `h` for all, and a drift of uniform(-a, a) x the mean
spacing a particle and axis, a = the traffic's drift share. Drawn on the
device in two calls of a torch.Generator seeded by the configuration's
`sample_seed`; the run's seed draws a permutation that numbers them."""

import torch

from benchmark.sample import generator


def draw(cfg: dict, seed: int, device, drift_share: float):
    """((x, y, z) float32 positions by particle id, (n,) float32 radii,
    (n, 3) float32 drift). Every seed runs the same particles and the
    same work a step, under other ids, in another input order and another
    first split over the ranks."""
    n, lo, length = cfg["n"], cfg["box"]["lo"], cfg["box"]["length"]
    g = generator(cfg["sample_seed"], device)
    pos = torch.rand((3, n), generator=g, device=device, dtype=torch.float32) * length + lo
    spacing = length * (1.0 / n) ** (1.0 / 3.0)
    drift = (torch.rand((n, 3), generator=g, device=device, dtype=torch.float32) * 2.0 - 1.0) \
        * (drift_share * spacing)
    order = torch.randperm(n, generator=generator(seed, device), device=device)
    h = torch.full((n,), cfg["h"], dtype=torch.float32, device=device)
    return (pos[0, order], pos[1, order], pos[2, order]), h, drift[order]
