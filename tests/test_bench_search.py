"""The neighbour-list deployment (the cell uniform-2M.search) at a few
hundred or thousand particles on the CPU: its configuration against
uniform-2M-h012's particle numbers, the plain reference of neighbour
lists (benchmark/reference/neighbor_lists.py) against an O(n^2) search,
the comparison (benchmark/reference/compare_search.py) counting a planted
wrong index, dropped entry, missing padding or repeated entry in an
overflowing row, the bfloat16 control failing it, the roofline's bound,
the traffic module's contract, and the cell run end to end through
`benchmark.run` on the CPU at a tiny size."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import control_search
from benchmark.cells import load_cell, load_module
from benchmark.reference import compare_search
from benchmark.reference.neighbor_lists import neighbor_lists

import torch_threads  # noqa: F401  (two intra-op threads per xdist worker)

REPO = pathlib.Path(__file__).resolve().parent.parent
N = 4000


def _sample(n, seed, h_lo=0.05, h_hi=0.1):
    g = torch.Generator().manual_seed(seed)
    x, y, z = torch.rand((3, n), generator=g)
    return x, y, z, h_lo + (h_hi - h_lo) * torch.rand(n, generator=g)


def test_search_config_runs_the_counts_particles():
    """Every number of uniform-2M-h012 under the same key but the cell
    list's, which the search does not use; the list's width and the
    traversal's settings added; nothing cut; a source of its own."""
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    name = next(w["config"] for w in spec["workloads"] if w["name"] == "uniform-2M.search")
    entry = next(c for c in spec["configs"] if c["name"] == name)
    assert entry["name"] == "uniform-2M-h012-ngmax200" and entry["reduced"] == []
    counts = json.loads((REPO / "benchmark" / "configs" / "uniform-2M-h012.json").read_text())
    search = json.loads((REPO / entry["file"]).read_text())
    descriptive = {"deployment", "source", "assumed", "reduced"}
    for k, v in counts.items():
        if k not in descriptive | {"cell_level", "cell_cap"}:
            assert search[k] == v, k
    assert "cell_level" not in search and "cell_cap" not in search
    assert {k for k in search if k not in counts} == {"ng_max", "group_size", "cand_leaf_cap", "frontier_cap",
                                                     "run_cap"}
    assert search["ng_max"] == 200 and search["n"] == 2_000_000 and search["h"] == 0.012
    assert search["source"] == entry["source"]
    assert entry["source"] not in [c["source"] for c in spec["configs"] if c["name"] != entry["name"]]


@pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "open"])
def test_reference_lists_equal_brute_force(periodic):
    """Every pair tested in one O(n^2) pass with the same float32
    operations and image: the counts and the sorted lists equal."""
    n = 300
    x, y, z, h = _sample(n, 5)
    counts, lists = neighbor_lists(x, y, z, h, 0.0, 1.0, periodic=periodic)
    d2 = None
    for c in (x, y, z):
        d = c[:, None] - c[None, :]
        if periodic:
            d = d - 1.0 * torch.floor(d * 1.0 + 0.5)
        d2 = d * d if d2 is None else d2 + d * d
    hit = (d2 < ((2.0 * h) * (2.0 * h))[:, None]) & ~torch.eye(n, dtype=torch.bool)
    assert torch.equal(counts, hit.sum(dim=1)) and float(counts.double().mean()) > 3.0
    assert lists.shape == (n, int(counts.max()))
    for i in range(n):
        assert torch.equal(lists[i][lists[i] >= 0], torch.nonzero(hit[i]).reshape(-1)), i
        assert bool((lists[i][int(counts[i]):] == -1).all())


def _faults(rows, counts, lists):
    n = counts.numel()
    ids = torch.arange(n)
    return compare_search.list_faults(rows, ids, ids, counts, lists, n)


def test_comparison_counts_planted_faults():
    """Rows made from the reference (each slot its id; at ng_max 8 some
    rows overflow and hold their first 8 neighbours) read no fault; each
    planted fault is counted in its row alone."""
    n, ng_max = 400, 8
    counts, lists = neighbor_lists(*_sample(n, 9), 0.0, 1.0)
    rows = torch.full((n, ng_max), -1, dtype=torch.int64)
    rows[:, :min(ng_max, lists.shape[1])] = lists[:, :ng_max]
    assert int(_faults(rows, counts, lists).sum()) == 0
    fits = torch.nonzero((counts > 1) & (counts < ng_max)).reshape(-1)
    over = torch.nonzero(counts > ng_max).reshape(-1)
    assert fits.numel() >= 3 and over.numel() >= 2
    a, b, c = (int(i) for i in fits[:3])
    d, e = (int(i) for i in over[:2])
    planted = rows.clone()
    planted[a, 0] = next(j for j in range(n) if j != a and j not in lists[a].tolist())  # a wrong index
    planted[b, int(counts[b]) - 1] = -1  # a dropped entry
    planted[c, int(counts[c])], planted[c, 0] = int(planted[c, 0]), -1  # padding before an entry
    planted[d, 1] = planted[d, 0]  # a neighbour twice in an overflowing row
    planted[e, 0] = e  # the target itself
    bad = _faults(planted, counts, lists)
    assert torch.nonzero(bad).reshape(-1).tolist() == sorted([a, b, c, d, e])
    # the row's order does not matter; the reference's first ng_max are not required
    shuffled = rows.clone()
    k = int(counts[a])
    shuffled[a, :k] = rows[a, :k].flip(0)
    shuffled[d] = lists[d, int(counts[d]) - ng_max:int(counts[d])]
    assert int(_faults(shuffled, counts, lists).sum()) == 0


@pytest.mark.parametrize("seed", [13, 4_000_000_007])
def test_bfloat16_control_is_not_correct(seed):
    """The control at 4,000 particles of the cell's configuration (h
    scaled to keep its 116 neighbours, so 2h is 8x the cell's and
    bfloat16's rounding of the positions moves fewer pairs across it than
    at the cell's size)."""
    cell = load_cell("uniform-2M.search")
    cfg = {**cell["config"], "n": N, "h": 0.012 * (2e6 / N) ** (1 / 3)}
    numbers = control_search.readings({"config": cfg, "traffic": cell["traffic"]}, seed, 3, torch.device("cpu"))
    assert numbers["list_mismatch"] > 0.75 * N and numbers["count_mismatch"] > 0


def test_search_roofline_bound():
    from benchmark.roofline_search import search_bound_s

    # bytes bind at 2M particles, 116 neighbours, rows of 200 slots
    assert search_bound_s(2e6 * 116, 2e6, 200) == pytest.approx(2e6 * (16 + 4 + 1600) / 3.35e12)
    assert search_bound_s(1e12, 1, 0) == pytest.approx(1e13 / 67e12)


def test_traffic_module_contract():
    cell = load_cell("uniform-2M.search")
    assert cell["chips"] == 1 and cell["traffic"]["step"] == "search"
    assert {m["name"] for m in cell["end_to_end"]} == {"step_rate", "peak_mem_gib", "setup_s"}
    assert {m["name"] for m in cell["per_layer"]} == {"search_ms", "search_roofline"}
    mod = load_module("traffic", "search")
    for name in ("PHASES", "LIMITS", "load_kernels", "setup", "step", "grow", "check"):
        assert hasattr(mod, name), name
    assert mod.PHASES[:4] == ("drift", "sync", "search", "carry") and "neighbors.pass" in mod.PHASES
    assert mod.LIMITS == compare_search.LIMITS and set(mod.LIMITS.values()) == {0}


def test_cell_runs_on_the_cpu(tmp_path):
    """The cell's step, check and readers through `benchmark.run --device
    cpu`, on a copy of the benchmark with a 4,000-particle configuration
    of the cell's (h scaled to keep 116 neighbours), traced: set-up grows
    the capacities the smaller tree needs, and the run is correct."""
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    os.symlink(REPO / "cstone_tpu_torch", tmp_path / "cstone_tpu_torch")
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    base = json.loads((REPO / "benchmark" / "configs" / "uniform-2M-h012-ngmax200.json").read_text())
    tiny = {**base, "n": N, "h": 0.012 * (2e6 / N) ** (1 / 3), "tree_capacity": 4096, "cand_leaf_cap": 128}
    (tmp_path / "benchmark" / "configs" / "tiny.json").write_text(json.dumps(tiny))
    spec["configs"].append({"name": "tiny", "source": "https://example.org/tiny", "reduced": ["n"],
                            "file": "benchmark/configs/tiny.json", "why": "a CPU test"})
    spec["workloads"].append({"name": "tiny.search", "config": "tiny", "traffic": "search", "chips": 1,
                              "why": "a CPU test"})
    for m in spec["per_layer"]:
        if m["name"].startswith("search"):
            m["workloads"].append("tiny.search")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    env = dict(os.environ, PYTHONPATH="", OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "tiny.search", "--seed",
                           "3000000019", "--seconds", "1", "--trace", "1", "--device", "cpu"],
                          cwd=tmp_path, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "cand_leaf_cap grown to 256" in proc.stderr
    line = json.loads(proc.stdout.splitlines()[-1])
    assert line["correct"] and line["compared"]["list_mismatch"] == {"value": 0, "limit": 0}
    assert "search_ms" in line["metrics"] and "search_roofline" not in line["metrics"]  # no card, no roofline
