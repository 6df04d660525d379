"""The tiered cell list's rules, the benchmark's own copies of the port's
(traversal/tiered.py: `_tier_index`, `choose_tier_levels`, `tier_caps`),
so that a change to the program cannot move them: the tier of each
particle, the grid levels of the tiers and the ELL caps sized from the
sample's occupancy. A clustered configuration's `tier_levels`,
`tier_caps` and `cross_caps` are what these rules give at its sample,
and its `tree_capacity` sits above the leaves of the sample's
cornerstone tree; both are found on the card, where the cells draw:

    python3 -m benchmark.tiers --workload gauss-2M.tiered [--device cuda|cpu]

prints them as one JSON line (`sizes`)."""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch


def tier_index(h: torch.Tensor, length: float, levels) -> torch.Tensor:
    """(n,) int64 tier of each radius: the finest listed level whose cell
    side, in float32, is at least 2h (levels ascending, levels[0]
    admissible for every h)."""
    side = torch.tensor(length, dtype=torch.float32, device=h.device)
    tier = torch.zeros(h.shape, dtype=torch.int64, device=h.device)
    for j, level in enumerate(levels[1:], start=1):
        tier = torch.where((side / float(1 << level)) >= 2.0 * h, j, tier)
    return tier


def choose_tier_levels(h: np.ndarray, length: float, max_tiers: int = 3, max_level: int = 7) -> tuple:
    """Up to `max_tiers` ascending grid levels spanning the radii: the
    coarsest admissible for max(h), the finest for the 5th percentile,
    one level an octave between; the coarsest and the finest
    `max_tiers - 1` kept where there are more."""
    h = np.asarray(h, np.float64)
    lo = int(np.floor(np.log2(length / (2.0 * float(h.max())))))
    if lo < 2:
        raise ValueError(f"max(h) = {float(h.max()):.4g} needs a grid coarser than level 2")
    lo = min(lo, max_level)
    hi = min(max_level, max(lo, int(np.floor(np.log2(length / (2.0 * float(np.quantile(h, 0.05))))))))
    levels = list(range(lo, hi + 1))
    if len(levels) > max_tiers:
        levels = [levels[0]] + levels[-(max_tiers - 1):]
    return tuple(levels)


def tier_caps(pos: np.ndarray, h: np.ndarray, lo: float, length: float, levels, slack: float = 1.3):
    """(each tier's ELL cap at its own level, {(a, b): tier b's cap at
    level_a}): the fullest cell's occupancy x slack + 8, up to a multiple
    of 64, at least 64."""
    adm = np.floor(np.log2(length / (2.0 * np.asarray(h, np.float64))))
    tier = np.zeros(len(h), np.int64)
    for j, level in enumerate(levels[1:], start=1):
        tier[adm >= level] = j

    def fullest(mask, level):
        if not mask.any():
            return 0
        d = 1 << level
        ijk = np.clip(((pos[mask] - lo) / length * d).astype(np.int64), 0, d - 1)
        return int(np.bincount((ijk[:, 0] * d + ijk[:, 1]) * d + ijk[:, 2], minlength=d ** 3).max())

    def cap(m):
        return max(64, int(-(-int(m * slack + 8) // 64) * 64))

    T = len(levels)
    same = tuple(cap(fullest(tier == t, levels[t])) for t in range(T))
    cross = {(a, b): cap(fullest(tier == b, levels[a])) for a in range(T) for b in range(a + 1, T)}
    return same, cross


def sizes(cfg: dict, device, max_tiers: int = 3, slack: float = 1.3) -> dict:
    """The configuration's sizes at its sample (seed 0: the ids do not
    move them): the tiers' levels and caps, the leaves of the cornerstone
    tree and the radii's range."""
    from . import sample
    from .reference.keys import sfc_keys
    from .reference.octree import cornerstone_tree

    lo, length = cfg["box"]["lo"], cfg["box"]["length"]
    xyz, h, _ = sample.draw(cfg, 0, device, 0.0)
    leaves = cornerstone_tree(sfc_keys(*xyz, lo, length, cfg["curve"]), cfg["bucket"])[1].numel()
    pos = torch.stack(xyz, 1).cpu().numpy()
    hn = h.cpu().numpy()
    levels = choose_tier_levels(hn, length, max_tiers)
    same, cross = tier_caps(pos, hn, lo, length, levels, slack)
    tiers = torch.bincount(tier_index(h, length, levels), minlength=len(levels)).tolist()
    return {"tier_levels": list(levels), "tier_caps": list(same),
            "cross_caps": {f"{a},{b}": c for (a, b), c in cross.items()}, "tier_particles": tiers,
            "leaves": leaves, "h_min": float(hn.min()), "h_median": float(np.median(hn)), "h_max": float(hn.max())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("tiers: no CUDA device", file=sys.stderr)
        return 2
    from .cells import load_cell

    cell = load_cell(args.workload)
    print(json.dumps({"workload": args.workload, "device": args.device,
                      "sizes": sizes(cell["config"], torch.device(args.device))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
