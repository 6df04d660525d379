"""The control of the comparison that decides `correct` in the cells of the
neighbour search (traffic `search`): the reference put in the program's
place and computed in bfloat16, the precision below the configuration's
float32, at a cell's own size. Its outputs are held to the float32
reference by the same numbers and limits as a run's; the control has to
come out not correct, by `list_mismatch` among others. The benchmark's
own runs do not run it.

    python3 -m benchmark.control_search --workload uniform-2M.search --seeds 11,12,13 [--steps 5]

For each seed: the cell's sample after `--steps` drift steps, the
float32 reference (keys, the octree, neighbor_lists.py's counts and
lists), and the control's outputs (positions and radii rounded to
bfloat16; keys, the octree and the neighbour lists computed from them,
the pair tests' arithmetic in bfloat16, each row cut to the cell's
ng_max), every particle owned once at the slot of its id. Prints one JSON
line a seed with its numbers, then one with each number's smallest
reading over the seeds. One card (or the CPU with --device cpu).
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import sample
from .cells import load_cell, load_module
from .reference.compare_search import LIMITS, step_numbers
from .reference.keys import sfc_keys
from .reference.neighbor_lists import neighbor_lists
from .reference.octree import cornerstone_tree


def control_outputs(xyz, h, lo: float, length: float, bucket: int, k: int, curve: str, ng_max: int) -> dict:
    """The reference's outputs in bfloat16, shaped as a step's outputs."""
    bf = torch.bfloat16
    bxyz = tuple(c.to(bf) for c in xyz)
    keys = sfc_keys(*bxyz, lo, length, curve)
    tk, tc = cornerstone_tree(keys, bucket)
    n = keys.numel()
    counts, lists = neighbor_lists(*bxyz, h.to(bf), lo, length)
    rows = torch.full((n, ng_max), -1, dtype=torch.int64, device=keys.device)
    w = min(ng_max, lists.shape[1])
    rows[:, :w] = lists[:, :w]
    return {"k": k, "ids": torch.arange(n, device=keys.device), "keys": keys,
            "xyz": tuple(c.float() for c in bxyz), "counts": counts, "lists": rows, "start": 0, "end": n,
            "tree": (tk, tc, tk.numel() - 1)}


def readings(cell: dict, seed: int, steps: int, device) -> dict:
    cfg = cell["config"]
    lo, length = cfg["box"]["lo"], cfg["box"]["length"]
    stepper = load_module("traffic", cell["traffic"]["step"])
    xyz0, h, drift = sample.draw(cfg, seed, device, cell["traffic"]["drift_share"])
    xyz = sample.positions_after(xyz0, drift, steps, lo, length)
    ref = stepper.reference_step(xyz, h, lo, length, cfg["bucket"], cfg["curve"])
    out = control_outputs(xyz, h, lo, length, cfg["bucket"], steps, cfg["curve"], cfg["ng_max"])
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
