"""The clustered sample: cornerstone-octree's RandomGaussianCoordinates
(test/coord_samples/random.hpp), the sample test/performance/octree.cpp
builds its octree on: each axis normal about the cube's centre with sigma
= side / 5, clamped to [lo, lo + length]. Each particle's smoothing
length follows its local density as in SPH, h_i = (3 N / (32 pi
rho_i))^(1/3), so that about N neighbours lie within 2h (4/3 pi (2h)^3
rho = N, N the configuration's `target_neighbours`); rho_i is the count
of the particle's cell of a 2^`density_level` grid (the particle itself
included) over the cell's volume (the port's utils/workloads.adaptive_h,
written again here). The drift is uniform(-a, a) x the particle's own local
spacing rho_i^(-1/3) a particle and axis, a = the traffic's drift share:
every particle moves the same share of its spacing as in the uniform
cells. Drawn on the device from the configuration's `sample_seed`; the
run's seed draws a permutation that numbers them."""

import math

import torch

from benchmark.sample import generator


def local_density(pos: torch.Tensor, lo: float, length: float, level: int) -> torch.Tensor:
    """(n,) float64 particles a unit volume in each particle's grid cell."""
    d = 1 << level
    ijk = ((pos.double() - lo) / length * d).long().clamp(0, d - 1)
    cell = (ijk[0] * d + ijk[1]) * d + ijk[2]
    return torch.bincount(cell, minlength=d ** 3)[cell].double() / (length / d) ** 3


def draw(cfg: dict, seed: int, device, drift_share: float):
    """((x, y, z) float32 positions by particle id, (n,) float32 radii,
    (n, 3) float32 drift). Every seed runs the same particles and the
    same work a step, under other ids and in another input order."""
    n, lo, length = cfg["n"], cfg["box"]["lo"], cfg["box"]["length"]
    g = generator(cfg["sample_seed"], device)
    sigma = length / 5.0
    pos = torch.randn((3, n), generator=g, device=device, dtype=torch.float32) * sigma + (lo + length / 2.0)
    pos = pos.clamp(lo, lo + length)
    rho = local_density(pos, lo, length, cfg["density_level"])
    h = ((3.0 * cfg["target_neighbours"] / (32.0 * math.pi * rho)) ** (1.0 / 3.0)).float()
    spacing = (rho ** (-1.0 / 3.0)).float()
    drift = (torch.rand((n, 3), generator=g, device=device, dtype=torch.float32) * 2.0 - 1.0) \
        * (drift_share * spacing)[:, None]
    order = torch.randperm(n, generator=generator(seed, device), device=device)
    return (pos[0, order], pos[1, order], pos[2, order]), h[order], drift[order]
