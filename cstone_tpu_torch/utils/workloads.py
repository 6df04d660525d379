"""Clustered sample generators and adaptive smoothing lengths (copied
from cstone_tpu/utils/workloads.py, which cannot be imported without jax;
reference: test/coord_samples/random.hpp:143-176
RandomGaussianCoordinates, test/coord_samples/plummer.hpp:21-80).

`adaptive_h` assigns SPH-style smoothing lengths h_i ~ rho_i^{-1/3},
calibrated so the MEAN neighbor count (d < 2h) hits a target: the input of
the tiered cell list (traversal/tiered.py). `wrap_threshold_ell` and
`wrap_threshold_cross` build the stencil inputs on which a symmetric pass
that reused one end's d2 across a periodic wrap would miscount;
`mixed_image_runs` the run-streaming counts input whose tiles need every
kind of minimum image; `cell_rows` particles whose cells hold rows of
set lengths (the one-sided stencil's chunk edges) and `dense_groups` the
dense group x candidate counts input with every kind of edge. Host-side
numpy, set-up code."""

from __future__ import annotations

import numpy as np

__all__ = ["gaussian_coords", "plummer_coords", "adaptive_h", "grid_density", "wrap_threshold_ell",
           "wrap_threshold_cross", "mixed_image_runs", "cell_rows", "dense_groups"]


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


def wrap_threshold_ell(axis: int, seed: int = 0):
    """Level-2 ELL input of the periodic unit box holding one pair across
    the periodic edge of `axis` whose float32 d2 differs between its ends,
    ((x_i - (x_j + L))^2 against (x_j - (x_i - L))^2): particle i in the
    last cell along `axis`, j in the first, both in cell 2 of the other
    axes. Both radii are set to the larger d2, so exactly one end counts
    the other, and a pass that reused one end's d2 at the other end gets
    that end wrong.

    Returns (planes (4, 64, 4) float32: x, y, z, r2 in row-major cell
    order; valid (64, 4) bool; level 2; d2 from i's end; d2 from j's end).
    """
    f = np.float32
    rng = np.random.RandomState(seed)
    while True:
        xi, xj = f(1.0) - f(rng.uniform(0.001, 0.1)), f(rng.uniform(0.001, 0.1))
        di, dj = xi - (xj + f(1.0)), xj - (xi - f(1.0))
        if di * di != dj * dj:
            break
    level, D, cap = 2, 4, 4
    planes = np.zeros((4, D ** 3, cap), dtype=np.float32)
    valid = np.zeros((D ** 3, cap), dtype=bool)
    for coord, idx in ((xi, D - 1), (xj, 0)):
        ijk = [2, 2, 2]
        ijk[axis] = idx
        cell = (ijk[0] * D + ijk[1]) * D + ijk[2]
        pos = [f(0.6)] * 3
        pos[axis] = coord
        planes[:3, cell, 0] = pos
        planes[3, cell, 0] = max(di * di, dj * dj)
        valid[cell, 0] = True
    return planes, valid, level, di * di, dj * dj


def wrap_threshold_cross(axis: int, swap: bool = False, seed: int = 0):
    """The pair of `wrap_threshold_ell` split into two one-particle tables
    for the cross pass: A holds particle i (the last cell along `axis`) and
    B particle j (the first cell), or the other way round with `swap`. Both
    radii are the larger d2, so exactly one table counts the other, and a
    pass that reused one end's d2 at the other end gets that end wrong.

    Returns (planes (4, 64, 4) float32 shared by both tables: x, y, z, r2;
    valid of A; valid of B; level 2; d2 from A's end; d2 from B's end).
    """
    planes, valid, level, d2_i, d2_j = wrap_threshold_ell(axis, seed)
    D = 1 << level
    ijk = [2, 2, 2]
    ijk[axis] = D - 1
    cell_i = (ijk[0] * D + ijk[1]) * D + ijk[2]
    in_i = np.zeros_like(valid)
    in_i[cell_i] = valid[cell_i]
    in_j = valid & ~in_i
    if swap:
        return planes, in_j, in_i, level, d2_j, d2_i
    return planes, in_i, in_j, level, d2_i, d2_j


def mixed_image_runs(group_size: int, n_groups: int, periodic: bool = True, seed: int = 0):
    """Run-streaming counts input (the arguments of pairwise_count_runs, as
    numpy) on which the floor(d / L + 1/2) image of the unit box varies in
    every way a tile can see. Particle g*G + t is target t of group g. The
    first third of the groups is packed around centres near the faces and
    the middle of the box; the second third copies it shifted by exactly
    L/2 on x and on some other axes, so many pairs sit at exactly +-L/2;
    the last third mirrors it through the faces (x -> 1023/1024 - x), so
    groups near one face meet candidates near the opposite one. Each
    group's runs are ranges of its own particles and of its two copies'
    (or originals') and of a random group's, with empty runs between. Radii
    up to 0.6, some targets padded (r2 = -1). Coordinates lie on the 1/1024
    grid, so every shift and mirror is exact.

    Returns (targets (n_groups, G, 3), r2 (n_groups, G), run_start and
    run_len (n_groups, 8) int64, xs, ys, zs (n,), box_params (9,)): float32
    unless stated. n_groups must be a multiple of 3.
    """
    if n_groups % 3:
        raise ValueError(f"n_groups must be a multiple of 3, got {n_groups}")
    rng = np.random.RandomState(seed)
    G, third = group_size, n_groups // 3
    top = 1023.0 / 1024.0
    orig = np.empty((third, G, 3))
    for g in range(third):
        w = rng.choice([0.004, 0.01, 0.04], size=3)
        centre = [rng.choice([w[a] + 0.002, top - w[a] - 0.002, 0.5, rng.uniform(w[a], 1 - w[a])])
                  for a in range(3)]
        orig[g] = np.asarray(centre) + rng.uniform(-1.0, 1.0, size=(G, 3)) * w
    orig = np.clip(np.round(orig * 1024.0) / 1024.0, 0.0, top)
    shift = rng.randint(0, 2, size=(third, 1, 3)) * 0.5
    shift[:, :, 0] = 0.5
    flip = rng.randint(0, 2, size=(third, 1, 3)).astype(bool)
    flip[:, :, 0] = True
    pos = np.concatenate([orig, (orig + shift) % 1.0, np.where(flip, top - orig, orig)])
    n = n_groups * G
    flat = pos.reshape(n, 3).astype(np.float32)

    R = 8
    run_start = np.zeros((n_groups, R), np.int64)
    run_len = np.zeros((n_groups, R), np.int64)
    for g in range(n_groups):
        kin = [(g + k * third) % n_groups for k in range(3)] + [rng.randint(n_groups)]
        for r, other in zip((0, 2, 4, 6), kin):
            s = other * G + rng.randint(0, G // 2 + 1)
            run_start[g, r] = s
            run_len[g, r] = min(n, s + rng.randint(max(1, G // 4), G + 1)) - s
    r2 = rng.uniform(0.0, 0.36, size=(n_groups, G)).astype(np.float32)
    r2[rng.uniform(size=r2.shape) < 0.1] = -1.0
    box_params = np.array([1, 1, 1, 1, 1, 1] + [float(periodic)] * 3, np.float32)
    return (flat.reshape(n_groups, G, 3), r2, run_start, run_len,
            flat[:, 0].copy(), flat[:, 1].copy(), flat[:, 2].copy(), box_params)


def cell_rows(level: int, row_lengths=(0, 1, 32, 33, 64), seed: int = 0):
    """Particles in the unit box whose cells at `level` hold one of
    `row_lengths` particles each (drawn per cell), uniform inside the cell (off its faces),
    with h uniform in [0.25, 0.5] cell sides (so 2h fits a cell side): ELL
    rows that end before, at and just past a 32-slot chunk edge, and empty
    ones, for the stencil kernels.

    Returns (pos (n, 3), h (n,)), float32, in no particular order.
    """
    rng = np.random.RandomState(seed)
    D = 1 << level
    per_cell = np.asarray(row_lengths)[rng.randint(len(row_lengths), size=D ** 3)]
    cell = np.repeat(np.arange(D ** 3), per_cell)
    ijk = np.stack([cell // (D * D), (cell // D) % D, cell % D], axis=-1)
    # kept off the cell faces, so float rounding moves no particle to the next cell
    pos = ((ijk + rng.uniform(0.001, 0.999, size=ijk.shape)) / D).astype(np.float32)
    h = (rng.uniform(0.25, 0.5, size=cell.shape[0]) / D).astype(np.float32)
    return pos, h


def dense_groups(group_size: int, n_groups: int = 8, n_cand: int = 300, seed: int = 0):
    """Dense group x candidate counts input (the arguments of
    pairwise_count, as numpy) with every edge a tiled kernel can meet.
    Targets of group g are particles g*G + t clustered around a centre;
    candidates lie around the same centre with random particle indices.
    Each row's valid slots are a prefix of random length with a hole of -1
    slots inside it; group 1 has no valid candidate; at slots 0, 255, 256,
    511, 512 and C - 1 (the edges of 256-candidate tiles) and at four
    random slots a valid candidate is one of the group's own targets, at
    its own coordinates (d2 = 0, so only the index test excludes it); about
    a tenth of the targets have r2 = -1. Empty slots hold index -1 and the
    coordinate FLT_MAX / 2 (find_neighbors' poison). n_cand need not be a
    multiple of any tile.

    Returns (targets (n_groups, G, 3), r2 (n_groups, G), cand (n_groups,
    C, 3) float32, cidx (n_groups, C) int32).
    """
    rng = np.random.RandomState(seed)
    G, C = group_size, n_cand
    centres = rng.uniform(0.1, 0.9, size=(n_groups, 1, 3))
    targets = (centres + rng.uniform(-0.05, 0.05, size=(n_groups, G, 3))).astype(np.float32)
    r2 = rng.uniform(0.0, 0.01, size=(n_groups, G)).astype(np.float32)
    r2[rng.uniform(size=r2.shape) < 0.1] = -1.0
    cand = (centres + rng.uniform(-0.1, 0.1, size=(n_groups, C, 3))).astype(np.float32)
    cidx = rng.randint(0, n_groups * G, size=(n_groups, C)).astype(np.int32)
    k = np.arange(C)
    valid = k[None, :] < rng.randint(C // 2, C + 1, size=(n_groups, 1))
    hole = rng.randint(0, max(1, C // 2), size=(n_groups, 1))
    valid &= ~((k[None, :] >= hole) & (k[None, :] < hole + max(1, C // 10)))
    valid[1 % n_groups] = False
    for g in range(n_groups):
        for s in [e for e in (0, 255, 256, 511, 512, C - 1) if 0 <= e < C] + list(rng.randint(0, C, 4)):
            if valid[g, s]:
                t = rng.randint(G)
                cand[g, s], cidx[g, s] = targets[g, t], g * G + t
    cand[~valid] = np.float32(np.finfo(np.float32).max / np.float32(2.0))
    cidx[~valid] = -1
    return targets, r2, cand, cidx
