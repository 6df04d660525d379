"""The control of the comparison that decides `correct` in the cells of the
SPH density (traffic `density`): the reference put in the program's
place and computed in bfloat16, the precision below the configuration's
float32, at a cell's own size. Its outputs are held to the float32
reference by the same numbers and limits as a run's; the control has to
come out not correct, by `density_mismatch` among others. The
benchmark's own runs do not run it.

    python3 -m benchmark.control_density --workload uniform-2M.density --seeds 11,12,13 [--steps 5]

For each seed: the cell's sample after `--steps` drift steps and its
masses, the float32 reference (keys, the octree, density.py's densities
and neighbours), and the control's outputs (positions, radii and masses
rounded to bfloat16; keys, the octree and the densities computed from
them, the density's arithmetic in bfloat16), every particle owned once.
Prints one JSON line a seed with its numbers, then one with each
number's smallest reading over the seeds. One card (or the CPU with
--device cpu).
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import sample
from .cells import load_cell, load_module
from .reference.compare_density import LIMITS, step_numbers
from .reference.density import sph_density
from .reference.keys import sfc_keys
from .reference.octree import cornerstone_tree


def control_outputs(xyz, h, m, lo: float, length: float, bucket: int, k: int, curve: str) -> dict:
    """The reference's outputs in bfloat16, shaped as a step's outputs."""
    bf = torch.bfloat16
    bxyz = tuple(c.to(bf) for c in xyz)
    keys = sfc_keys(*bxyz, lo, length, curve)
    tk, tc = cornerstone_tree(keys, bucket)
    n = keys.numel()
    rho = sph_density(*bxyz, h.to(bf), m.to(bf), lo, length)[0]
    return {"k": k, "ids": torch.arange(n, device=keys.device), "keys": keys, "xyz": tuple(c.float() for c in bxyz),
            "rho": rho.float(), "start": 0, "end": n, "tree": (tk, tc, tk.numel() - 1)}


def readings(cell: dict, seed: int, steps: int, device) -> dict:
    cfg = cell["config"]
    lo, length = cfg["box"]["lo"], cfg["box"]["length"]
    stepper = load_module("traffic", cell["traffic"]["step"])
    xyz0, h, drift = sample.draw(cfg, seed, device, cell["traffic"]["drift_share"])
    m = stepper.masses(cfg, device)
    xyz = sample.positions_after(xyz0, drift, steps, lo, length)
    ref = stepper.reference_step(xyz, h, m, lo, length, cfg["bucket"], cfg["curve"])
    out = control_outputs(xyz, h, m, lo, length, cfg["bucket"], steps, cfg["curve"])
    numbers = step_numbers(out, ref)
    numbers["failed_steps"] = 0
    return numbers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    device = torch.device(args.device)
    least = None
    for seed in (int(s) for s in args.seeds.split(",")):
        numbers = readings(cell, seed, args.steps, device)
        correct = all(numbers[k] <= LIMITS[k] for k in LIMITS)
        print(json.dumps({"seed": seed, "correct": correct, "numbers": numbers}), flush=True)
        least = numbers if least is None else {k: min(least[k], numbers[k]) for k in numbers}
    print(json.dumps({"workload": args.workload, "least": least, "limits": LIMITS}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
