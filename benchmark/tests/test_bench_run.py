"""Whole runs of tiny cells on the CPU, each started by BENCHMARK.json's
command: the last line, the launcher of several ranks, cells and metrics
added as new files, the look for a card, the modules a run may not load,
and a checkout that holds the benchmark alone."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from bench_helpers import REPO, TINY, make_root, run_cell

KEYS = {"correct", "attempted", "failed", "metrics", "device"}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def last_line(out):
    line = json.loads(out[-1])
    assert KEYS <= set(line) and list(line)[-1] == "compared"
    assert set(line) - KEYS <= {"breakdown", "compared"}
    for name, m in line["metrics"].items():
        assert NAME.match(name) and UNIT.match(m["unit"]) and isinstance(m["value"], float)
    for k in ("platform", "kind", "count", "memory_peak_bytes"):
        assert k in line["device"]
    return line


def test_one_rank_untraced(tiny_root):
    rc, out, err = run_cell(tiny_root, "tiny-1.counts", seed=2_147_483_659)
    assert rc == 0, err
    line = last_line(out)
    assert line["correct"] and line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {"step_rate", "setup_s"}  # the device's peak memory: not on the CPU
    tail = err.strip().splitlines()[-len(line["compared"]):]
    assert tail == [f"compared {k} {c['value']} limit {c['limit']}" for k, c in line["compared"].items()]


def test_one_rank_traced(tiny_root):
    rc, out, err = run_cell(tiny_root, "tiny-1.counts", seed=11, trace=1)
    assert rc == 0, err
    line = last_line(out)
    assert line["correct"] and {"sync_ms", "sync_torch_ops", "celllist_ms"} <= set(line["metrics"])
    assert not {"device_idle", "nbpass_roofline"} & set(line["metrics"])  # device numbers: the card's only
    assert {"busy_s", "window_s"} <= set(line["device"]) and "breakdown" in line


def test_four_rank_processes_traced(tiny_root):
    rc, out, err = run_cell(tiny_root, "tiny-4.counts", seed=3_000_000_019, seconds=2.0, trace=1)
    assert rc == 0, err
    line = last_line(out)
    assert line["correct"] and line["device"]["count"] == 4
    assert {"exchange_rounds", "exchange_mb", "sync_ms"} <= set(line["metrics"])
    assert line["metrics"]["exchange_rounds"]["value"] > 0


NEW_STEP = '''"""A step added as a file: the counts step, whose check also hands over
the number of steps it checked."""
from benchmark.cells import load_module

base = load_module("traffic", "counts")
PHASES, LIMITS = base.PHASES, base.LIMITS
load_kernels, setup, step, grow = base.load_kernels, base.setup, base.step, base.grow


def check(rank, checked):
    numbers, facts = base.check(rank, checked)
    return numbers, {**facts, "checked": len(checked)}
'''


def test_new_config_traffic_and_metric_are_files(tmp_path):
    """A cell, its configuration, a traffic mix, the step it names and a
    per-layer metric added as new files and entries, no file of the
    harness edited."""
    root = make_root(tmp_path, cells={"tiny-x": {**TINY["tiny-1"], "n": 3000}})
    bench = root / "benchmark"
    tr = json.loads((bench / "traffic" / "counts.json").read_text())
    (bench / "traffic" / "counts-x.json").write_text(json.dumps({**tr, "step": "counts_x", "warm_steps": 2}))
    (bench / "traffic" / "counts_x.py").write_text(NEW_STEP)
    (bench / "metrics" / "checked_steps.py").write_text("def read(rec):\n    return rec['step'].get('checked')\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    next(w for w in spec["workloads"] if w["name"] == "tiny-x.counts")["traffic"] = "counts-x"
    spec["per_layer"].append({"name": "checked_steps", "unit": "steps", "better": "higher",
                              "source": "program_counter", "layer": "client", "moves": "step_rate",
                              "workloads": ["tiny-x.counts"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    rc, out, err = run_cell(root, "tiny-x.counts", seed=5, trace=1)
    assert rc == 0, err
    line = last_line(out)
    assert line["correct"] and line["metrics"]["checked_steps"]["value"] in (1.0, 2.0)


@pytest.mark.parametrize("change", [{"curve": "peano"}, {"key_bits": 32}, {"sample": "plummer-missing"}],
                         ids=["curve", "key_bits", "sample"])
def test_unknown_sample_or_curve_is_refused(tmp_path, change):
    root = make_root(tmp_path, cells={"tiny-u": {**TINY["tiny-1"], **change}})
    rc, out, err = run_cell(root, "tiny-u.counts", seed=6, seconds=0.5)
    assert rc != 0 and out == [], err
    assert str(next(iter(change.values()))) in err


PLANT_JAX_IN_RANK_1 = '''

_window = window


def window(rank, seconds, seed):
    if rank.rank == 1:
        import sys
        import types

        sys.modules["jax"] = types.ModuleType("jax")
    return _window(rank, seconds, seed)
'''


def test_a_rank_that_loads_jax_in_its_window_ends_the_run(tmp_path):
    """Rank 1 of 4 loads jax in its window: every rank looks once its
    window has closed, so the run prints no result."""
    root = make_root(tmp_path, cells={"tiny-4": TINY["tiny-4"]})
    harness = root / "benchmark" / "harness.py"
    harness.write_text(harness.read_text() + PLANT_JAX_IN_RANK_1)
    rc, out, err = run_cell(root, "tiny-4.counts", seed=13, seconds=0.5)
    assert rc == 3 and out == [], err
    assert "rank 1: forbidden modules loaded: ['jax']" in err


PLANT_FAST_CLOCK_IN_RANK_1 = '''

_trace_slices = trace_slices


def trace_slices(rank, slice_s, drained_steps):
    if rank.rank != 1:
        return _trace_slices(rank, slice_s, drained_steps)
    import types

    real = time
    start = real.perf_counter()
    globals()["time"] = types.SimpleNamespace(perf_counter=lambda: start + 4 * (real.perf_counter() - start))
    try:
        return _trace_slices(rank, slice_s, drained_steps)
    finally:
        globals()["time"] = real
'''


def test_traced_slice_ends_on_rank_0s_clock(tmp_path):
    """Rank 1's clock runs four times as fast through the traced slices,
    which last 2 s (several tiny steps): every rank still steps as often
    as rank 0, whose clock ends the slice for all, so their collectives
    pair up and the run is correct. Were each rank to end its slice on
    its own clock, rank 1 would leave early and a collective of its
    would meet one of another kind (gloo aborts the run)."""
    root = make_root(tmp_path, cells={"tiny-4": TINY["tiny-4"]}, traffic_over={"trace_slice_s": 2.0})
    harness = root / "benchmark" / "harness.py"
    harness.write_text(harness.read_text() + PLANT_FAST_CLOCK_IN_RANK_1)
    rc, out, err = run_cell(root, "tiny-4.counts", seed=2_236_067_977, seconds=0.5, trace=1)
    assert rc == 0, err[-4000:]
    assert last_line(out)["correct"]


@pytest.mark.parametrize("base,sizes,own_only", [
    ("tiny-1", {"tree_capacity": 16, "cell_cap": 64}, False),
    ("tiny-1", {"cell_cap": 64}, True),
    ("tiny-4", {"tree_capacity": 16, "cell_cap": 64}, False),
], ids=["sync-and-cells", "cells-alone", "four-ranks"])
def test_set_up_grows_the_capacities(tmp_path, base, sizes, own_only):
    """Capacities too small for the sample: set-up retries under the
    Domain's sync_with_retry (tree, focus and the p2p capacities) and
    grows the step's own cell-list cap, then the run is correct."""
    root = make_root(tmp_path, cells={"tiny-g": {**TINY[base], **sizes}})
    rc, out, err = run_cell(root, "tiny-g.counts", seed=17, seconds=0.5)
    assert rc == 0, err
    assert last_line(out)["correct"]
    timing = json.loads([ln for ln in err.splitlines() if ln.startswith("benchmark: {")][-1][len("benchmark: "):])
    retries = timing["retries"]
    assert retries and timing["cold_tries"] == len(retries) + 1
    assert any(own for _, _, own in retries)
    assert any(detail == [] for _, detail, _ in retries) == own_only  # the cell list alone overflowed


def test_no_card_no_result(tiny_root):
    proc = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "tiny-1.counts", "--seed", "1",
                           "--seconds", "1", "--trace", "0"], cwd=tiny_root, capture_output=True, text=True,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""), timeout=120)
    assert proc.returncode == 2 and proc.stdout.strip() == ""


RUN_AND_LIST = """
import json, sys
from benchmark.run import main
rc = main(["--workload", "tiny-1.counts", "--seed", "3", "--seconds", "0.5", "--device", "cpu"])
print(json.dumps({"rc": rc, "top": sorted({m.split(".")[0] for m in sys.modules})}))
"""


def test_run_loads_no_jax(tiny_root):
    proc = subprocess.run([sys.executable, "-c", RUN_AND_LIST], cwd=tiny_root, capture_output=True, text=True,
                          timeout=240)
    got = json.loads(proc.stdout.splitlines()[-1])
    assert got["rc"] == 0, proc.stderr
    assert "cstone_tpu_torch" in got["top"]
    assert not {"jax", "jaxlib", "flax", "cstone_tpu", "bench", "chip_smoke"} & set(got["top"])


def test_run_with_jax_loaded_fails(tiny_root):
    code = ("import sys, types; sys.modules['jax'] = types.ModuleType('jax'); "
            "from benchmark.run import main; sys.exit(main(['--workload', 'tiny-1.counts', '--seed', '1', "
            "'--seconds', '0.5', '--device', 'cpu']))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tiny_root, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 3 and proc.stdout.strip() == "" and "jax" in proc.stderr


def test_forbidden_names_compare_whole():
    from benchmark.cells import forbidden_modules

    sys.modules["cstone_tpu_torch_lookalike.x"] = sys.modules[__name__]
    try:
        assert "cstone_tpu" not in forbidden_modules()
        sys.modules["cstone_tpu.sfc"] = sys.modules[__name__]
        assert "cstone_tpu" in forbidden_modules()
    finally:
        sys.modules.pop("cstone_tpu.sfc", None)
        sys.modules.pop("cstone_tpu_torch_lookalike.x", None)


def test_benchmark_alone_fails(tmp_path):
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    proc = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "uniform-2M.counts", "--seed", "1",
                           "--seconds", "1", "--trace", "0", "--device", "cpu"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
