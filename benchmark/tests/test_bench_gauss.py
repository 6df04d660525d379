"""The clustered cell on the CPU: a tiny copy of gauss-2M.tiered (the
configuration's fields at 8,000 particles and 30 neighbours, its tiers
sized by benchmark/tiers.py on the CPU's sample) added as new files to a
copy of the benchmark, run whole by BENCHMARK.json's command, untraced
and traced, and read by progtrace; the reference's control comes out not
correct at that size. On the card: the shipped configuration's sizes are
what the rules give at its sample."""

import json
import os
import subprocess
import sys

import pytest
import torch

from bench_helpers import BENCH, make_root, run_cell
from benchmark import control_adaptive, tiers
from benchmark.cells import load_cell
from benchmark.reference.compare import LIMITS

SHIPPED = json.loads((BENCH / "configs" / "gauss-2M-adaptive-h.json").read_text())
TINY = {"n": 8000, "target_neighbours": 30, "density_level": 3, "tree_capacity": 4096}
SPANS = ("tiered.partition", "tiered.pack", "tiered.same", "tiered.cross", "tiered.scatter")


@pytest.fixture(scope="module")
def gauss_root(tmp_path_factory):
    """A benchmark copy with the cell tiny-gauss.tiered: its configuration,
    sized on the CPU, and its entry in BENCHMARK.json's lists."""
    root = make_root(tmp_path_factory.mktemp("gauss"), cells={})
    cfg = {**SHIPPED, **TINY}
    size = tiers.sizes(cfg, torch.device("cpu"))
    cfg.update({k: size[k] for k in ("tier_levels", "tier_caps", "cross_caps")})
    assert len(cfg["tier_levels"]) == 3 and size["leaves"] < TINY["tree_capacity"]
    (root / "benchmark" / "configs" / "tiny-gauss.json").write_text(json.dumps(cfg))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny-gauss", "source": "https://example.org/tiny", "reduced": ["n"],
                            "file": "benchmark/configs/tiny-gauss.json", "why": "a CPU test"})
    spec["workloads"].append({"name": "tiny-gauss.tiered", "config": "tiny-gauss", "traffic": "tiered", "chips": 1,
                              "why": "a CPU test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "gauss-2M.tiered" in m.get("workloads", []):
            m["workloads"].append("tiny-gauss.tiered")
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return root


def test_untraced_run_is_correct(gauss_root):
    rc, out, err = run_cell(gauss_root, "tiny-gauss.tiered", seed=2_147_483_659, timeout=400)
    assert rc == 0, err[-4000:]
    line = json.loads(out[-1])
    assert line["correct"] and line["attempted"] > 0 and line["failed"] == 0
    assert all(c["value"] == 0 for c in line["compared"].values())
    assert set(line["metrics"]) == {"step_rate", "setup_s"}  # the device's peak memory: not on the CPU


def test_traced_run_reports_the_cell_list(gauss_root):
    rc, out, err = run_cell(gauss_root, "tiny-gauss.tiered", seed=31, trace=1, timeout=400)
    assert rc == 0, err[-4000:]
    line = json.loads(out[-1])
    assert line["correct"] and line["metrics"]["tiered_ms"]["value"] > 0
    assert not {"tiered_roofline", "cross_roofline"} & set(line["metrics"])  # device numbers: the card's only
    assert not {"celllist_ms", "nbpass_roofline", "sync_ms"} & set(line["metrics"])  # the uniform cells' own


def test_progtrace_reads_the_tiered_spans(gauss_root):
    env = dict(os.environ, PYTHONPATH="", OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-m", "benchmark.progtrace", "--workload", "tiny-gauss.tiered",
                           "--seed", "3000000019", "--seconds", "1", "--device", "cpu"], cwd=gauss_root, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    (rank,) = json.loads(proc.stdout.splitlines()[-1])["per_rank"]
    prog = rank["program"]
    steps = prog["spans"]["sync"]["calls"]
    assert rank["failed"] == 0 and steps == prog["steps"] >= 1
    calls = {"tiered.partition": 1, "tiered.pack": 6, "tiered.same": 3, "tiered.cross": 3, "tiered.scatter": 10}
    for name in SPANS:
        assert prog["spans"][name]["calls"] == calls[name] * steps, name
    cfg = load_cell("tiny-gauss.tiered", gauss_root)["config"]
    levels = cfg["tier_levels"]
    slots = sum(c << 3 * lv for c, lv in zip(cfg["tier_caps"], levels)) + \
        sum(c << 3 * levels[int(p.split(",")[0])] for p, c in cfg["cross_caps"].items())
    assert prog["counts"]["tiered.tiers"] == 3 * steps and prog["counts"]["tiered.cross_passes"] == 3 * steps
    assert prog["counts"]["tiered.slots"] == slots * steps


@pytest.mark.parametrize("seed", [11, 2_147_483_659])
def test_control_is_not_correct(gauss_root, seed):
    numbers = control_adaptive.readings(load_cell("tiny-gauss.tiered", gauss_root), seed, 5, torch.device("cpu"))
    assert any(numbers[k] > LIMITS[k] for k in LIMITS)
    assert numbers["count_mismatch"] > 0 and numbers["key_mismatch"] > 0


@pytest.mark.cuda
def test_shipped_sizes_are_the_rules_at_the_sample():
    """tier_levels, tier_caps and cross_caps are what benchmark/tiers.py's
    rules give at sample_seed's particles on the card, and the tree's
    capacity is above the sample's leaves."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    size = tiers.sizes(SHIPPED, torch.device("cuda"))
    for key in ("tier_levels", "tier_caps", "cross_caps"):
        assert size[key] == SHIPPED[key], key
    assert size["leaves"] < SHIPPED["tree_capacity"]
