"""Clustered sample generator (copied from cstone_tpu/utils/workloads.py,
which cannot be imported without jax; reference:
test/coord_samples/random.hpp:143-176 RandomGaussianCoordinates)."""

from __future__ import annotations

import numpy as np

__all__ = ["gaussian_coords"]


def gaussian_coords(n: int, limits, seed: int = 42, dtype=np.float32) -> np.ndarray:
    """(n, 3) normal blob at the box center, sigma = side/5 per dim,
    clamped to the box."""
    rng = np.random.RandomState(seed)
    lims = np.asarray(limits, np.float64).reshape(3, 2)
    center = lims.mean(axis=1)
    sigma = (lims[:, 1] - lims[:, 0]) / 5.0
    pos = rng.normal(center, sigma, size=(n, 3))
    return np.clip(pos, lims[:, 0], lims[:, 1]).astype(dtype)
