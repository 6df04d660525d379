"""The spanned slice (benchmark/progtrace.py): the program's spans read
from a device trace made up by hand, then whole runs of the tiny cells
on the CPU, one rank and four gloo rank processes, in which each
per-layer number is there or None where the cell or the CPU lacks it,
and the readers of a traced run read what they read without it."""

import json
import os
import subprocess
import sys

import pytest

from benchmark import progtrace
from benchmark.cells import load_module

MS = 1_000_000  # ns
PHASES = ("drift", "sync", "celllist", "carry", "flags")
STAGES = ("sync.box", "sync.keys", "sync.tree", "sync.assign", "sync.exchange", "sync.focus", "sync.halos",
          "sync.layout", "sync.halo_exchange", "sync.overflow")


def _events():
    """One step: the harness's "sync" phase around the program's "sync"
    span with two stages, a collective inside the second, a host read,
    and the device-side image of a program span."""
    return [("slice", False, 0, 100 * MS, 1),
            ("sync", False, 0, 80 * MS, 2),  # the harness's phase
            ("sync", False, 1 * MS, 79 * MS, 3),  # the program's span
            ("sync.keys", False, 2 * MS, 30 * MS, 4),
            ("sync.tree", False, 30 * MS, 78 * MS, 5),
            ("comm.all_reduce", False, 40 * MS, 70 * MS, 6),
            ("flags", False, 80 * MS, 100 * MS, 7),
            ("cudaLaunchKernel", False, 3 * MS, 3 * MS + 10, 50),
            ("cudaLaunchKernel", False, 41 * MS, 41 * MS + 10, 51),
            ("cudaStreamSynchronize", False, 50 * MS, 60 * MS, 52),
            ("cudaLaunchKernel", False, 85 * MS, 85 * MS + 10, 53),
            ("encode", True, 5 * MS, 25 * MS, 50),
            ("ncclDevKernel_AllReduce", True, 45 * MS, 65 * MS, 51),
            ("sync.tree", True, 30 * MS, 78 * MS, 5),  # an image: no device operation
            ("reduce_flags", True, 86 * MS, 87 * MS, 53)]


def test_the_table_reads_the_spans_from_the_trace():
    tally = {"spans": {"sync": {"calls": 1, "host_s": 0.078}, "sync.keys": {"calls": 1, "host_s": 0.028},
                       "sync.tree": {"calls": 1, "host_s": 0.048},
                       "comm.all_reduce": {"calls": 1, "host_s": 0.030}},
             "counts": {"tree.rounds": 2}}
    out = progtrace.reduce(_events(), tally, PHASES, steps=1, on_card=True)
    sync, keys, tree = out["spans"]["sync"], out["spans"]["sync.keys"], out["spans"]["sync.tree"]
    assert abs(out["busy_s"] - 0.041) < 1e-12  # the image of sync.tree is not counted
    assert (sync["device_ops"], sync["device_ms"], sync["host_syncs"], sync["host_sync_ms"]) == (2, 40.0, 1, 10.0)
    assert abs(sync["idle_ms"] - 38.0) < 1e-9  # the program's interval [1, 79), not the phase's
    assert (keys["device_ms"], keys["host_syncs"], abs(keys["idle_ms"] - 8.0) < 1e-9) == (20.0, 0, True)
    assert (tree["device_ms"], tree["host_syncs"], tree["host_ms"]) == (20.0, 1, 48.0)
    assert out["comm"]["device_ms"] == 20.0 and out["comm"]["top_ops"][0][0] == "ncclDevKernel_AllReduce"
    assert out["sync_api_calls"] == {"cudaLaunchKernel": 2, "cudaStreamSynchronize": 1}
    # gaps 65-86 (in the collective), 25-45 (keys), 87-100 (the harness's flags), 0-5 (its sync phase)
    assert [name for name, _ in out["idle_gaps"]] == ["comm.all_reduce", "sync.keys", "flags", "sync"]
    assert abs(out["idle_gaps"][0][1] - 0.021) < 1e-12
    m = progtrace.program_metrics(out, [progtrace.collective_ms(out)] * 4)
    assert m == pytest.approx({"sync_host_syncs": 1.0, "keys_ms": 28.0, "tree_ms": 48.0, "focus_ms": None,
                               "tree_rounds": 2.0, "focus_rounds": None, "collective_ms": 20.0})


def _run(root, workload, seed):
    """`python3 -m benchmark.progtrace` of a tiny cell in `root`, on the
    CPU: its last line, one JSON object."""
    env = dict(os.environ, PYTHONPATH="", OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-m", "benchmark.progtrace", "--workload", workload, "--seed", str(seed),
                           "--seconds", "1", "--device", "cpu"], cwd=root, env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.splitlines()[-1])


def _check_rank(rank):
    prog, syncs = rank["program"], rank["program"]["spans"]["sync"]["calls"]
    assert rank["failed"] == 0 and syncs == prog["steps"] >= 1
    for name in STAGES + ("celllist.pack", "celllist.pass", "celllist.scatter"):
        assert prog["spans"][name]["calls"] == syncs, name
    stage_ms = sum(prog["spans"][name]["host_ms"] for name in STAGES)
    assert 0.9 * prog["spans"]["sync"]["host_ms"] <= stage_ms <= prog["spans"]["sync"]["host_ms"]
    # the readers of a traced run take the untouched slice alone
    untouched = dict(rank["untouched"], slice_steps=rank["untouched"]["steps"])
    rec = {"on_card": False, "trace": untouched}
    with_program = {"on_card": False, "trace": dict(untouched, program=prog)}
    for name in ("sync_torch_ops", "device_idle"):
        reader = load_module("metrics", name).read
        assert reader(rec) == reader(with_program)
    assert untouched["sync_torch_ops"] > 0


def test_one_rank_on_the_cpu(tiny_root):
    out = _run(tiny_root, "tiny-1.counts", 2_147_483_659)
    (rank,) = out["per_rank"]
    _check_rank(rank)
    m = out["metrics"]
    for name in ("keys_ms", "tree_ms", "focus_ms", "tree_rounds"):
        assert isinstance(m[name], float) and m[name] >= 0.0, name
    assert m["keys_ms"] > 0.0 and m["focus_ms"] > 0.0
    # fast_focus at one rank: no converge loop; no collective; the CPU has no device trace
    assert m["focus_rounds"] is None and m["collective_ms"] is None and m["sync_host_syncs"] is None
    assert not any(n.startswith("comm.") for n in rank["program"]["spans"])


def test_four_gloo_ranks_on_the_cpu(tiny_root):
    out = _run(tiny_root, "tiny-4.counts", 3_000_000_019)
    assert [r["rank"] for r in out["per_rank"]] == [0, 1, 2, 3]
    for rank in out["per_rank"]:
        _check_rank(rank)
        spans = rank["program"]["spans"]
        assert spans["comm.all_to_all"]["calls"] > 0 and spans["comm.all_reduce"]["calls"] > 0
        assert rank["program"]["counts"]["focus.rounds"] >= spans["sync"]["calls"]
    m = out["metrics"]
    assert m["focus_rounds"] >= 1.0 and m["keys_ms"] > 0.0
    assert m["collective_ms"] is None and m["sync_host_syncs"] is None  # the card's only
