"""On the card: a tiny cell's whole run through the kernels, traced, reads
correct true with the device's numbers in it. Skips without a card."""

import json

import pytest

from bench_helpers import run_cell


@pytest.mark.cuda
def test_tiny_cell_on_the_card(tiny_root):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    rc, out, err = run_cell(tiny_root, "tiny-1.counts", seconds=2.0, trace=1, device="cuda")
    assert rc == 0, err
    line = json.loads(out[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert {"device_idle", "nbpass_roofline"} <= set(line["metrics"])
    assert 0 < line["metrics"]["nbpass_roofline"]["value"] <= 100
