"""The control: the reference put in the program's place and computed in
bfloat16 comes out not correct at a size a test can hold, on three
seeds; the float32 reference in the same place comes out correct."""

import pytest
import torch

from benchmark import control, sample
from benchmark.cells import load_cell
from benchmark.reference.compare import LIMITS, reference_step, step_numbers


@pytest.mark.parametrize("seed", [11, 2_147_483_659, 4_000_000_007])
@pytest.mark.parametrize("workload", ["tiny-1.counts", "tiny-4.counts"])
def test_control_fails(tiny_root, workload, seed):
    numbers = control.readings(load_cell(workload, tiny_root), seed, 5, torch.device("cpu"))
    assert any(numbers[k] > LIMITS[k] for k in LIMITS)
    assert numbers["count_mismatch"] > 0 and numbers["key_mismatch"] > 0


def test_reference_in_place_is_correct(tiny_root):
    cfg = load_cell("tiny-1.counts", tiny_root)["config"]
    xyz0, h, drift = sample.draw(cfg, 5, "cpu", 0.2)
    xyz = sample.positions_after(xyz0, drift, 4)
    ref = reference_step(xyz, h, 0.0, 1.0, cfg["bucket"])
    order = torch.argsort(ref["keys"])
    tk, tc = ref["tree"]
    out = {"ids": order, "keys": ref["keys"][order], "xyz": tuple(c[order] for c in xyz),
           "counts": ref["counts"][order], "start": 0, "end": cfg["n"], "tree": (tk, tc, tk.numel() - 1)}
    assert all(v == 0 for v in step_numbers(out, ref).values())
