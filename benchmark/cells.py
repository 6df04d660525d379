"""BENCHMARK.json's cells, the benchmark's modules found by name, and the
modules a run may not load, without torch: the launcher of several ranks
reads them before it imports it."""

from __future__ import annotations

import importlib.util
import json
import pathlib
import sys

BENCH_DIR = pathlib.Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "cstone_tpu", "bench", "chip_smoke")


def forbidden_modules() -> list:
    """Top-level names of loaded modules that a run may not load (the
    part before the first dot, compared whole: cstone_tpu_torch passes)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def load_module(kind: str, name: str):
    """`<kind>/<name>.py` of the benchmark (kind: metrics, samples or
    traffic), loaded once a process as `benchmark.<kind>.<name>`; raises
    on a name that has no file."""
    qual = f"benchmark.{kind}.{name}"
    if qual in sys.modules:
        return sys.modules[qual]
    path = BENCH_DIR / kind / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"no {kind} module {name!r} ({path.relative_to(ROOT)} is missing)")
    spec = importlib.util.spec_from_file_location(qual, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[qual] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[qual]
        raise
    return mod


def load_cell(workload: str, root: pathlib.Path = ROOT) -> dict:
    """The cell named `workload`: its BENCHMARK.json entry, configuration,
    traffic and the metrics it reports (end-to-end and per-layer)."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json (have {sorted(cells)})")
    cell = cells[workload]
    entry = next(c for c in spec["configs"] if c["name"] == cell["config"])

    def mine(ms):
        return [m for m in ms if workload in m.get("workloads", [workload])]

    return {"name": workload, "chips": cell["chips"], "config": json.loads((root / entry["file"]).read_text()),
            "traffic": json.loads((BENCH_DIR / "traffic" / f"{cell['traffic']}.json").read_text()),
            "end_to_end": mine(spec["end_to_end"]), "per_layer": mine(spec["per_layer"])}
