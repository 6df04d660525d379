"""What the cells' particles share, whatever their sample: the seeded
generator, the drift and the sizing rules. The benchmark's own copies, so
that a change to the program cannot move them.

A configuration's `sample` names the file `samples/<sample>.py` whose
`draw(cfg, seed, device, drift_share)` makes its particles. The drift is
bench.py's: every step moves each particle by its drift vector with
alternating sign (+d, -d, +d, ...), so that every step re-encodes and
re-sorts while the density stays put. The sizing rules are bench.py's
default_cell_cap and the port's choose_cell_level, written out again
here; the configuration files hold the numbers they give."""

from __future__ import annotations

import math

import torch


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 64))
    return g


def draw(cfg: dict, seed: int, device, drift_share: float):
    """The configuration's particles by id: ((x, y, z), h, drift), drawn
    by `samples/<cfg["sample"]>.py`."""
    from .cells import load_module

    return load_module("samples", cfg["sample"]).draw(cfg, seed, device, drift_share)


def drift_step(xyz, d, sgn: float, lo: float = 0.0, length: float = 1.0):
    """One drift of positions `xyz` by `d` ((n, 3) rows of the same
    particles), wrapped into the periodic cube: the harness applies it to
    the program's arrays in the window and the reference to its own."""
    return tuple(lo + (c - lo + sgn * d[:, i]) % length for i, c in enumerate(xyz))


def positions_after(xyz0, drift, steps: int, lo: float = 0.0, length: float = 1.0):
    """The positions by id after `steps` drift steps, the first +."""
    xyz, sgn = xyz0, 1.0
    for _ in range(steps):
        xyz = drift_step(xyz, drift, sgn, lo, length)
        sgn = -sgn
    return xyz


def choose_cell_level(length: float, h_max: float, max_level: int = 7) -> int:
    """The coarsest grid level whose cell side is at least 2 h_max, in
    [2, max_level] (the stencil needs 4 cells a periodic side)."""
    r = 2.0 * h_max
    level = int(math.floor(math.log2(length / r))) if r < length else 0
    return max(2, min(max_level, level))


def default_cell_cap(n: int, level: int, snapshots: int = 1) -> int:
    """bench.py's ELL cap: the Poisson occupancy tail over the cells and
    drift snapshots, a multiple of 64."""
    n_cells = float(1 << (3 * level)) * max(1, snapshots)
    mean = n / float(1 << (3 * level))
    cap = mean + math.sqrt(2.0 * math.log(n_cells) * mean) + 6.0
    return max(64, int(-(-cap // 64) * 64))


def local_capacity(n: int, ranks: int) -> int:
    """A rank's buffer: n at one rank; else the power of two above 2.05 x
    its share (its own particles and their halos)."""
    if ranks == 1:
        return n
    return 1 << math.ceil(math.log2(2.05 * -(-n // ranks)))
