"""Helpers of the benchmark's CPU tests: a throwaway copy of the
benchmark with tiny cells added as new files, run on the CPU through the
port's plain routes."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

BENCH = pathlib.Path(__file__).resolve().parent.parent
REPO = BENCH.parent

# a tiny cell of one rank and one of four: the shipped configurations'
# fields at a few thousand particles, h scaled to keep ~116 neighbours
TINY = {
    "tiny-1": {"n": 4000, "ranks": 1, "h": 0.012 * (2e6 / 4000) ** (1 / 3), "tree_capacity": 4096,
               "cell_level": 2, "cell_cap": 128},
    "tiny-4": {"n": 8000, "ranks": 4, "h": 0.012 * (2e6 / 2000) ** (1 / 3) * 4 ** (-1 / 3),
               "tree_capacity": 4096, "cell_level": 2, "cell_cap": 192},
}


def make_root(dest: pathlib.Path, cells=TINY, traffic_over=None) -> pathlib.Path:
    """A copy of BENCHMARK.json and benchmark/ under `dest`, the program
    linked in, with `cells` added: a configuration file each (the shipped
    one's fields with the cell's sizes) and a cell on the counts traffic
    (or on a copy of it with `traffic_over` applied, named "counts-test")."""
    shutil.copytree(BENCH, dest / "benchmark", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    os.symlink(REPO / "cstone_tpu_torch", dest / "cstone_tpu_torch")
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    base = json.loads((BENCH / "configs" / "uniform-2M-h012.json").read_text())
    traffic = "counts"
    if traffic_over:
        tr = json.loads((BENCH / "traffic" / "counts.json").read_text())
        tr.update(traffic_over)
        traffic = "counts-test"
        (dest / "benchmark" / "traffic" / f"{traffic}.json").write_text(json.dumps(tr))
    for name, sizes in cells.items():
        (dest / "benchmark" / "configs" / f"{name}.json").write_text(json.dumps({**base, **sizes}))
        spec["configs"].append({"name": name, "source": "https://example.org/tiny", "reduced": ["n"],
                                "file": f"benchmark/configs/{name}.json", "why": "a CPU test"})
        spec["workloads"].append({"name": f"{name}.counts", "config": name, "traffic": traffic,
                                  "chips": sizes["ranks"], "why": "a CPU test"})
        for m in spec["end_to_end"] + spec["per_layer"]:
            if "workloads" in m:
                m["workloads"].append(f"{name}.counts")
    (dest / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return dest


def run_cell(root: pathlib.Path, workload: str, seed: int = 7, seconds: float = 1.0, trace: int = 0,
             timeout: float = 240.0, device: str = "cpu"):
    """`python3 -m benchmark.run` in `root` (on the CPU unless `device`
    says otherwise): (exit code, stdout lines, stderr)."""
    env = dict(os.environ, PYTHONPATH="", OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", workload, "--seed", str(seed),
                           "--seconds", str(seconds), "--trace", str(trace), "--device", device],
                          cwd=root, env=env, capture_output=True, text=True, timeout=timeout)
    return proc.returncode, proc.stdout.splitlines(), proc.stderr
