"""Clustered sample generators and adaptive smoothing lengths (copied
from cstone_tpu/utils/workloads.py, which cannot be imported without jax;
reference: test/coord_samples/random.hpp:143-176
RandomGaussianCoordinates, test/coord_samples/plummer.hpp:21-80).

`adaptive_h` assigns SPH-style smoothing lengths h_i ~ rho_i^{-1/3},
calibrated so the MEAN neighbor count (d < 2h) hits a target: the input of
the tiered cell list (traversal/tiered.py). Host-side numpy, set-up code."""

from __future__ import annotations

import numpy as np

__all__ = ["gaussian_coords", "plummer_coords", "adaptive_h", "grid_density"]


def gaussian_coords(n: int, limits, seed: int = 42, dtype=np.float32) -> np.ndarray:
    """(n, 3) normal blob at the box center, sigma = side/5 per dim,
    clamped to the box."""
    rng = np.random.RandomState(seed)
    lims = np.asarray(limits, np.float64).reshape(3, 2)
    center = lims.mean(axis=1)
    sigma = (lims[:, 1] - lims[:, 0]) / 5.0
    pos = rng.normal(center, sigma, size=(n, 3))
    return np.clip(pos, lims[:, 0], lims[:, 1]).astype(dtype)


def plummer_coords(n: int, seed: int = 42, dtype=np.float32) -> np.ndarray:
    """(n, 3) Plummer-sphere sample (plummer.hpp:21-80): radii from the
    inverse cumulative mass profile R = (u^{-2/3} - 1)^{-1/2} with R>=100
    rejected, isotropic angles, scaled by 3*pi/16, recentered on the
    center of mass. Central density is ~3 orders of magnitude above the
    half-mass shell — the clustered stress case."""
    rng = np.random.RandomState(seed)
    out = np.empty((0, 3), np.float64)
    conv = 3.0 * np.pi / 16.0
    while out.shape[0] < n:
        m = max(n - out.shape[0], 1024)
        u = rng.uniform(0.0, 1.0, size=m)
        with np.errstate(divide="ignore", over="ignore"):
            R = 1.0 / np.sqrt(np.maximum(u ** (-2.0 / 3.0) - 1.0, 1e-30))
        R = R[R < 100.0]
        z = (1.0 - 2.0 * rng.uniform(size=R.shape[0])) * R
        theta = 2.0 * np.pi * rng.uniform(size=R.shape[0])
        rxy = np.sqrt(np.maximum(R * R - z * z, 0.0))
        pts = np.stack([rxy * np.cos(theta), rxy * np.sin(theta), z], axis=-1)
        out = np.concatenate([out, pts * conv])
    out = out[:n]
    out -= out.mean(axis=0, keepdims=True)
    return out.astype(dtype)


def grid_density(pos: np.ndarray, limits, level: int = 6) -> np.ndarray:
    """(n,) particles-per-cell local density estimate on a 2^level grid —
    cheap host-side stand-in for an SPH density iteration, good enough to
    calibrate adaptive smoothing lengths for benchmarks."""
    lims = np.asarray(limits, np.float64).reshape(3, 2)
    d = 1 << level
    span = lims[:, 1] - lims[:, 0]
    ijk = np.clip(
        ((pos - lims[:, 0]) / span * d).astype(np.int64), 0, d - 1
    )
    flat = (ijk[:, 0] * d + ijk[:, 1]) * d + ijk[:, 2]
    counts = np.bincount(flat, minlength=d * d * d)
    cell_vol = span.prod() / float(d) ** 3
    return (counts[flat] / cell_vol).astype(np.float64)


def adaptive_h(
    pos: np.ndarray,
    limits,
    target_mean_neighbors: float = 100.0,
    level: int = 6,
    h_min_factor: float = 1e-3,
) -> np.ndarray:
    """(n,) smoothing lengths h_i ~ rho_i^{-1/3} with the prefactor set so
    the MEAN count of particles within 2h is ~target_mean_neighbors
    (expected count = rho * 4/3 pi (2h)^3)."""
    rho = grid_density(pos, limits, level=level)
    rho = np.maximum(rho, rho[rho > 0].min())
    # 4/3 pi (2h)^3 rho = target  =>  h = (3 target / (32 pi rho))^{1/3}
    h = (3.0 * target_mean_neighbors / (32.0 * np.pi * rho)) ** (1.0 / 3.0)
    lims = np.asarray(limits, np.float64).reshape(3, 2)
    h_min = (lims[:, 1] - lims[:, 0]).min() * h_min_factor
    return np.maximum(h, h_min).astype(np.float32)
