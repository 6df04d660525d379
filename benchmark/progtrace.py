"""The program's own spans and counters (cstone_tpu_torch/utils/trace.py)
over one more profiled slice of steps, the spanned slice, and the
numbers they give by stage.

    python3 -m benchmark.progtrace --workload <cell> --seed <n> [--seconds <s>] [--device cuda|cpu]

sets a cell up as a run does (the step's kernels, the sample, the cold
and warm steps), steps it for --seconds (5 by default), profiles the
untouched slice and the drained steps of a traced run
(harness.trace_slices), then the spanned slice: the same steps for the
traffic's `trace_slice_s` on rank 0's clock, with the program's tracing
on (`trace.collect()`) under torch.profiler. A cell of several ranks runs
one process a rank (NCCL on the cards, gloo with --device cpu). It
prints one JSON object as its last line: per rank the spanned slice's
table by span, its counters, its idle gaps and both slices' mean step,
and the per-layer numbers of `program_metrics`.

The table holds, per span name: its calls and host ms (the tally); on a
card also the device ms and the number of the device operations that
host calls inside it launched (matched by correlation id), the CUDA host
synchronisations inside it and their host ms, and the device's idle ms
inside its intervals. A span's device-side images in the trace are
dropped by name: they are no device operations. Nothing here changes
what a traced run of the benchmark reports: the harness does not call
this module.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import sys
import time
from collections import defaultdict

import torch

from . import devtrace
from .spans import Spans, drain

# the host calls that wait for the card (torch's synchronous copies end in a stream synchronize)
HOST_SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy")
TOP_OPS = 3


def spanned_slice(rank, slice_s: float, phases: tuple) -> dict:
    """Steps `rank` for `slice_s` seconds on rank 0's clock (every rank
    makes the same steps, through the step's reduced flags) with the
    program's tracing on, under torch.profiler with the harness's phases
    recorded; returns the slice's table (`reduce`)."""
    from cstone_tpu_torch.utils import trace

    dev = rank.device
    rank.spans = Spans(dev, drained=False)
    rank.profiled = True
    drain(dev)
    with trace.collect() as tally:
        with devtrace.profiled(dev, phases + ("slice",)) as tr:
            with torch.profiler.record_function("slice"):
                t0 = time.perf_counter()
                n, stop = 0, False
                while not stop:
                    _, _, stop = rank.step(lambda: rank.rank == 0 and n >= 1 and time.perf_counter() - t0 >= slice_s)
                    n += 1
                drain(dev)
    rank.profiled = False
    return reduce(tr.events, tally.read(), phases, n, on_card=dev.type == "cuda")


def _innermost(intervals: list) -> list:
    """The sorted intervals that hold no other of the list: the harness's
    "sync" phase holds the program's "sync" span, and the program's is
    the one kept."""
    out = []
    for s, e in sorted(intervals, key=lambda iv: (iv[0], -iv[1])):
        while out and out[-1][0] <= s and e <= out[-1][1]:
            out.pop()
        out.append((s, e))
    return out


def _merged(intervals) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class _Inside:
    """Whether a time lies in a set of disjoint sorted intervals."""

    def __init__(self, intervals):
        self.iv = _merged(intervals)
        self.starts = [s for s, _ in self.iv]

    def __call__(self, t: int) -> bool:
        i = bisect.bisect_right(self.starts, t) - 1
        return i >= 0 and t < self.iv[i][1]


def _overlap_ns(busy: list, starts: list, lo: int, hi: int) -> int:
    """ns of [lo, hi) that the merged intervals `busy` cover."""
    total = 0
    for k in range(max(bisect.bisect_right(starts, lo) - 1, 0), len(busy)):
        s, e = busy[k]
        if s >= hi:
            break
        total += max(0, min(e, hi) - max(s, lo))
    return total


def reduce(events, tally: dict, phases: tuple, steps: int, on_card: bool) -> dict:
    """The spanned slice's table from its events (devtrace.profiled) and
    the thread's tally: per program span its calls and host ms and, on a
    card, its device ms, device operations, host synchronisations and
    idle ms; the counters; the idle gaps; the mean step."""
    names = set(tally["spans"])
    events = [ev for ev in events if not (ev[1] and ev[0] in names)]  # the spans' device-side images
    lo, hi = devtrace.spans_named(events, "slice")[0]
    host = defaultdict(list)
    for n, dev, s, e, _ in events:
        if not dev and (n in names or n in phases):
            host[n].append((s, e))
    spans = {n: _innermost(host[n]) for n in names}
    table = {n: {"calls": t["calls"], "host_ms": 1e3 * t["host_s"]} for n, t in tally["spans"].items()}
    ops = devtrace.device_ops(events, lo, hi)
    out = {"steps": steps, "step_ms": (hi - lo) / 1e6 / steps, "spans": table, "counts": tally["counts"],
           "busy_s": devtrace.union_s(ops), "window_s": (hi - lo) / 1e9,
           # named by the innermost range: a program span lies inside the harness's phase
           "idle_gaps": devtrace.idle_gaps(ops, host, lo, hi)}
    if not on_card:
        return out
    device = defaultdict(list)  # correlation id -> (duration ns, name) of the device operations
    for n, dev, s, e, c in events:
        if dev:
            device[c].append((e - s, n))
    api = [(s, e, c, n) for n, dev, s, e, c in events if not dev and devtrace.is_api_call(n)]
    busy = _merged((s, e) for s, e, _ in ops)
    starts = [s for s, _ in busy]

    def stats(intervals) -> dict:
        inside = _Inside(intervals)
        mine = [(s, e, c, n) for s, e, c, n in api if inside(s)]
        launched = [op for _, _, c, _ in mine for op in device.get(c, ())]
        waits = [(e - s) for s, e, _, n in mine if n in HOST_SYNCS]
        top = defaultdict(int)
        for d, n in launched:
            top[devtrace.short_name(n)] += d
        return {"device_ms": sum(d for d, _ in launched) / 1e6, "device_ops": len(launched),
                "host_syncs": len(waits), "host_sync_ms": sum(waits) / 1e6,
                "idle_ms": sum((e - s) - _overlap_ns(busy, starts, s, e) for s, e in inside.iv) / 1e6,
                "top_ops": [[n, t / 1e6] for n, t in sorted(top.items(), key=lambda kv: -kv[1])[:TOP_OPS]]}

    for n in names:
        table[n].update(stats(spans[n]))
    out["comm"] = stats([iv for n in names if n.startswith("comm.") for iv in spans[n]])
    inside_sync = _Inside(spans.get("sync", []))
    calls = defaultdict(int)
    for s, _, _, n in api:
        if inside_sync(s):
            calls[n] += 1
    out["sync_api_calls"] = dict(sorted(calls.items(), key=lambda kv: -kv[1]))
    return out


def program_metrics(program: dict, collective_ms_ranks=None) -> dict:
    """The per-layer numbers of the spanned slice, each the mean over its
    syncs (None where the slice lacks it): host synchronisations inside
    `sync` (a card's only), host ms of sync.keys, sync.tree and
    sync.focus, the passes of the global tree's and the focus tree's
    fixed points (the focus tree's only where it converges), and the
    device ms of the operations launched inside collectives, the mean
    over the ranks (several ranks on cards)."""
    spans = program["spans"]
    syncs = spans.get("sync", {}).get("calls", 0)
    if not syncs:
        return dict.fromkeys(("sync_host_syncs", "keys_ms", "tree_ms", "focus_ms", "tree_rounds", "focus_rounds",
                              "collective_ms"))
    counts = program["counts"]
    host_syncs = spans["sync"].get("host_syncs")

    def host_ms(name):
        return spans[name]["host_ms"] / syncs if name in spans else None

    return {"sync_host_syncs": None if host_syncs is None else host_syncs / syncs,
            "keys_ms": host_ms("sync.keys"), "tree_ms": host_ms("sync.tree"), "focus_ms": host_ms("sync.focus"),
            "tree_rounds": counts.get("tree.rounds", 0) / syncs,
            "focus_rounds": counts["focus.rounds"] / syncs if "focus.rounds" in counts else None,
            "collective_ms": sum(collective_ms_ranks) / len(collective_ms_ranks) if collective_ms_ranks else None}


def collective_ms(program: dict):
    """A rank's device ms inside its collectives, a sync (None off the
    card or without a collective)."""
    comm, syncs = program.get("comm"), program["spans"].get("sync", {}).get("calls", 0)
    if comm is None or not syncs or not any(n.startswith("comm.") for n in program["spans"]):
        return None
    return comm["device_ms"] / syncs


def rank_run(comm, workload: str, seed: int, seconds: float, device_type: str) -> dict:
    """One rank: set-up, a window of `seconds`, the traced run's slices,
    then the spanned slice."""
    from . import harness
    from .cells import load_cell, load_module

    torch.set_num_threads(1)
    cell = load_cell(workload)
    r = 0 if comm is None else comm.rank
    device = torch.device("cuda", r) if device_type == "cuda" else torch.device("cpu")
    tr = cell["traffic"]
    harness.load_kernels(load_module("traffic", tr["step"]), comm, device)
    rank = harness.Rank(cell, comm, device, seed, trace=False)
    rank.establish()
    drain(device)
    win = harness.window(rank, seconds, seed)
    untouched = harness.trace_slices(rank, tr["trace_slice_s"], tr["trace_drained_steps"])
    program = spanned_slice(rank, tr["trace_slice_s"], rank.stepper.PHASES + ("flags",))
    return {"rank": r, "window_steps": win["steps"], "failed": win["failed"],
            "untouched": {"steps": untouched["slice_steps"], "window_s": untouched["window_s"],
                          "step_ms": 1e3 * untouched["window_s"] / untouched["slice_steps"],
                          "busy_s": untouched["busy_s"], "sync_torch_ops": untouched["sync_torch_ops"],
                          "idle_gaps": untouched["idle_gaps"]},
            "program": program}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    from .cells import forbidden_modules, load_cell

    cell = load_cell(args.workload)
    ranks = cell["config"]["ranks"]
    if args.device == "cuda" and (not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]):
        print(f"progtrace: the cell needs {cell['chips']} cards", file=sys.stderr)
        return 2
    run_args = (args.workload, args.seed, args.seconds, args.device)
    if ranks == 1:
        per_rank = [rank_run(None, *run_args)]
    else:
        from benchmark.progtrace import rank_run as fn  # by its module's name: the spawned ranks import it
        from cstone_tpu_torch.parallel.dist import spawn_ranks

        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        per_rank = spawn_ranks(ranks, fn, *([a] * ranks for a in run_args),
                               backend="nccl" if args.device == "cuda" else "gloo", device=args.device,
                               timeout=600.0)
    coll = [collective_ms(r["program"]) for r in per_rank]
    coll = None if any(c is None for c in coll) else coll
    out = {"workload": args.workload, "seed": args.seed, "ranks": ranks,
           "device": torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu",
           "metrics": program_metrics(per_rank[0]["program"], coll), "collective_ms_ranks": coll,
           "per_rank": per_rank}
    bad = forbidden_modules()
    if bad:
        print(f"progtrace: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
