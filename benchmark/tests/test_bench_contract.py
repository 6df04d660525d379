"""BENCHMARK.json and the files it names keep to the benchmark's rules:
names, units, keys, sizes, and a file for every configuration, traffic
mix and metric."""

import json
import math
import re

import pytest

from bench_helpers import BENCH, REPO
from benchmark import sample
from benchmark.reference.keys import CURVES, KEY_BITS

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
ALL_METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def one_line(text, most=200):
    return isinstance(text, str) and 1 <= len(text) <= most and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= len(SPEC["command"]) <= 32 and all(one_line(w) for w in SPEC["command"])
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda c: c["name"])
def test_config(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and one_line(entry["why"]) and one_line(entry["source"])
    assert entry["source"].startswith("https://")
    assert entry["file"] == f"benchmark/configs/{entry['name']}.json"
    cfg = json.loads((REPO / entry["file"]).read_text())
    assert cfg["reduced"] == entry["reduced"] and len(entry["reduced"]) <= 16
    for key in ("sample", "sample_seed", "n", "ranks", "h", "bucket", "bucket_focus", "theta", "tree_capacity",
                "box", "curve", "key_bits", "exchange_mode", "protocol", "assumed"):
        assert key in cfg, key
    assert all(NAME.match(k) and k in cfg for k in entry["reduced"])
    assert (BENCH / "samples" / f"{cfg['sample']}.py").is_file()
    assert cfg["curve"] in CURVES and cfg["key_bits"] in KEY_BITS
    assert any(w["config"] == entry["name"] for w in SPEC["workloads"])


# the shipped configurations' own rules (a later configuration states its own)
SHIPPED = {"uniform-2M-h012": (2_000_000, 1, 0.012), "uniform-4x2M-h012": (8_000_000, 4, 0.012 * 4 ** (-1 / 3))}


@pytest.mark.parametrize("name", sorted(SHIPPED))
def test_shipped_config_rules(name):
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    n, ranks, h = SHIPPED[name]
    assert (cfg["n"], cfg["ranks"], cfg["sample"], cfg["curve"]) == (n, ranks, "uniform", "hilbert")
    assert abs(cfg["h"] - h) < 1e-12
    # the grid and its cap: the port's choose_cell_level and bench.py's default_cell_cap over 3 snapshots
    assert cfg["cell_level"] == sample.choose_cell_level(cfg["box"]["length"], cfg["h"])
    assert cfg["cell_cap"] == sample.default_cell_cap(cfg["n"], cfg["cell_level"], 3)
    assert abs(4 / 3 * math.pi * (2 * cfg["h"]) ** 3 * cfg["n"] - 115.8) < 0.1  # neighbor_driver's neighbours


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"]) and one_line(cell["why"])
    assert cell["chips"] in (1, 4)
    cfg = json.loads((BENCH / "configs" / f"{cell['config']}.json").read_text())
    assert cfg["ranks"] == cell["chips"]
    traffic = json.loads((BENCH / "traffic" / f"{cell['traffic']}.json").read_text())
    assert (BENCH / "traffic" / f"{traffic['step']}.py").is_file()
    reported = [m["name"] for m in SPEC["end_to_end"] if cell["name"] in m.get("workloads", [cell["name"]])]
    assert "setup_s" in reported and len(reported) >= 2
    assert any(cell["name"] in m.get("workloads", [cell["name"]]) for m in SPEC["per_layer"])


def test_cells_unique_and_few_on_four_chips():
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert len({w["name"] for w in SPEC["workloads"]}) == len(SPEC["workloads"])
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)


@pytest.mark.parametrize("metric", ALL_METRICS, ids=lambda m: m["name"])
def test_metric(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert (BENCH / "metrics" / f"{metric['name']}.py").is_file()
    names = {w["name"] for w in SPEC["workloads"]}
    assert set(metric.get("workloads", [])) <= names
    if metric in SPEC["end_to_end"]:
        assert set(metric) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert one_line(metric["layer"])
        assert metric["moves"] in {m["name"] for m in SPEC["end_to_end"]}
        if metric["name"].endswith("_roofline"):
            assert metric["unit"] == "%"


def test_metric_names_unique():
    names = [m["name"] for m in ALL_METRICS]
    assert len(set(names)) == len(names) and "setup_s" in names
    assert next(m for m in SPEC["end_to_end"] if m["name"] == "setup_s")["bound"] <= 0.25
