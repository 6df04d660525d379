"""One run of a cell on one rank: set-up, the measured window, the traced
slices, the comparison with the reference, and the numbers the metric
readers take.

A cell is BENCHMARK.json's entry. Its configuration (`configs/`), its
traffic mix (`traffic/<name>.json`), the step the mix names
(`traffic/<step>.py`), the sample the configuration names
(`samples/<sample>.py`) and its metric readers (`metrics/<name>.py`, each
a `read(record)` that returns a number or None) are files found by name.

Set-up makes the particles on the device from the seed, builds the
step's kernels (once a host, into the port's build directory in the
checkout), and runs the cold step and the warm steps under the Domain's
own `sync_with_retry`, which grows the capacities a sync reports; the
harness grows only what the step's own calls report. It ends at the
first timed step. The window runs steps until --seconds have passed;
each step is timed on the host clock from the end of the one before to
its own overflow read. A traced run (--trace 1) times the step's phases
with the device drained around them and counts collectives in its
window, then counts the torch operations of one sync, then profiles a
slice of untouched steps (device busy time, idle gaps, the top device
operations) and a few steps with the phases drained (each phase's device
time).
"""

from __future__ import annotations

import contextlib
import time

import torch

from . import devtrace, sample
from .cells import load_module
from .reference.keys import CURVES, KEY_BITS
from .spans import CommTally, OpCounter, Spans, drain


def read_metrics(metrics: list, record: dict) -> dict:
    """Each metric's reader (metrics/<name>.py) on the run's record; a
    reader that finds nothing returns None and the metric is left out."""
    out = {}
    for m in metrics:
        value = load_module("metrics", m["name"]).read(record)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def load_kernels(stepper, comm, device) -> None:
    """Build the step's kernels once a host: rank 0 builds into the port's
    build directory, then the others load the built files."""
    if device.type != "cuda":
        return
    if comm is None or comm.rank == 0:
        stepper.load_kernels(device)
    if comm is not None:
        comm.all_reduce_flag(True)
        stepper.load_kernels(device)


def to_device(out, device):
    """A step's outputs with every tensor moved to `device`."""
    if isinstance(out, torch.Tensor):
        return out.to(device)
    if isinstance(out, (tuple, list)):
        return type(out)(to_device(o, device) for o in out)
    if isinstance(out, dict):
        return {k: to_device(v, device) for k, v in out.items()}
    return out


class Rank:
    """One rank's Domain, state and input; the step module the traffic
    names drives them."""

    def __init__(self, cell: dict, comm, device, seed: int, trace: bool):
        cfg, tr = cell["config"], cell["traffic"]
        self.cfg, self.tr, self.comm, self.device = cfg, tr, comm, device
        self.rank, self.ranks = (comm.rank, comm.n_ranks) if comm is not None else (0, 1)
        if self.ranks != cfg["ranks"]:
            raise SystemExit(f"the configuration runs {cfg['ranks']} ranks, this run has {self.ranks}")
        if cfg["curve"] not in CURVES or cfg["key_bits"] not in KEY_BITS:
            raise SystemExit(f"the reference has no {cfg['key_bits']}-bit {cfg['curve']!r} keys "
                             f"(curves {sorted(CURVES)}, key bits {KEY_BITS})")
        self.stepper = load_module("traffic", tr["step"])
        self.lo, self.length = cfg["box"]["lo"], cfg["box"]["length"]
        self.xyz0, self.h, self.drift = sample.draw(cfg, seed, device, tr["drift_share"])
        self.caps = {"local": sample.local_capacity(cfg["n"], self.ranks), "tree": cfg["tree_capacity"],
                     "focus": cfg["tree_capacity"], "move": 0, "treelet": 0, "halo": 0}
        self.spans = Spans(device, drained=False)
        self.profiled = False
        self.ops = None  # an OpCounter around the next sync
        self.tally = CommTally(comm) if (trace and comm is not None) else None
        self.exchange = []  # (calls, bytes) of each sync, counted by the tally
        self.stepper.setup(self)

    def build(self, caps: dict) -> None:
        """A fresh Domain with capacities `caps` and a fresh state; the
        input is the rank's strided slice r::R of the sample, padded to
        the local capacity."""
        import numpy as np
        from cstone_tpu_torch.domain import Domain
        from cstone_tpu_torch.sfc import PERIODIC, make_box

        cfg, dev = self.cfg, self.device
        self.caps = caps
        self.domain = Domain(bucket_size=cfg["bucket"], bucket_size_focus=cfg["bucket_focus"], theta=cfg["theta"],
                             key_dtype=np.uint64, curve=cfg["curve"],
                             tree_capacity=caps["tree"], focus_capacity=caps["focus"], comm=self.comm,
                             exchange_mode=cfg["exchange_mode"], protocol=cfg["protocol"], device=dev,
                             move_cap=caps["move"], treelet_cap=caps["treelet"], halo_req_cap=caps["halo"],
                             halo_cap=caps["halo"])
        box = make_box(self.lo, self.lo + self.length, boundaries=PERIODIC, device=dev)
        self.state = self.domain.init_state(box=box, boundaries=(1, 1, 1))
        ids = torch.arange(self.rank, cfg["n"], self.ranks, device=dev)
        cap = caps["local"]

        def pad(a, fill):
            out = torch.full((cap,), fill, dtype=a.dtype, device=dev)
            out[:a.numel()] = a
            return out

        self.inp = {"xyz": tuple(pad(c[ids], 0.0) for c in self.xyz0), "h": pad(self.h[ids], 0.0),
                    "ids": pad(ids, -1), "n": torch.tensor(ids.numel(), device=dev)}
        self.k, self.sgn = 0, 1.0

    @contextlib.contextmanager
    def phase(self, name: str):
        with contextlib.ExitStack() as stack:
            if self.profiled:
                stack.enter_context(torch.profiler.record_function(name))
            stack.enter_context(self.spans(name))
            if name == "sync" and self.ops is not None:
                stack.enter_context(self.ops)
            yield

    def sync(self, xyz, h, n):
        """Domain.sync of the step's input, in the "sync" phase, with the
        collectives it makes counted in a traced run."""
        before = self.tally.read() if self.tally is not None else None
        with self.phase("sync"):
            state, res = self.domain.sync(self.state, *xyz, h, n_local=n)
        if before is not None:
            after = self.tally.read()
            self.exchange.append((after[0] - before[0], after[1] - before[1]))
        return state, res

    def step(self, stop=lambda: False):
        """One timestep; returns (overflow, the step's own overflow, stop),
        read on the host once, the largest of all ranks. The last step's
        outputs are let go first, so that they do not stay on the card
        through this one."""
        self.out = self.res = None
        self.out, self.res, own = self.stepper.step(self)
        with self.phase("flags"):
            zero = torch.zeros((), dtype=torch.int64, device=self.res.overflow.device)
            flags = torch.stack([self.res.overflow.to(torch.int64),
                                 zero if own is None else own.to(torch.int64).reshape(())])
            if self.comm is None:
                ovf, o = flags.tolist()
                return ovf, o, stop()
            flags = torch.cat([flags, torch.tensor([int(stop())], device=flags.device)])
            ovf, o, s = self.comm.all_reduce(flags, "max").tolist()
            return ovf, o, bool(s)

    def establish(self) -> int:
        """The cold step and the warm steps under the Domain's
        sync_with_retry, which rebuilds with the capacities a sync names
        grown; the step's own capacity grows here. Returns the tries."""
        from cstone_tpu_torch.domain import sync_with_retry

        tries, warm = self.tr["cold_tries"], self.tr["warm_steps"]
        self.retries = []  # each try that overflowed: (step, overflow detail, the step's own flag)
        own_short = False

        def run_sync(caps):
            nonlocal own_short
            own_short = False
            self.build(caps)
            for _ in range(1 + warm):
                ovf, own, _ = self.step()
                if ovf or own:
                    self.retries.append((self.k, self.res.overflow_detail.tolist() if ovf else [], bool(own)))
                    if own:
                        self.stepper.grow(self)
                        own_short = not ovf
                    break
            return self.res

        caps = self.caps
        for _ in range(tries + 1):
            _, caps = sync_with_retry(run_sync, caps, max_retries=tries)
            if not own_short:
                return len(self.retries) + 1
        raise RuntimeError(f"the step's own capacity still overflows after {tries} retries: {self.retries}")

    def free(self) -> None:
        """Drop the program's state; what the checked steps produced stays."""
        self.domain = self.state = self.res = self.inp = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def window(rank: Rank, seconds: float, seed: int) -> dict:
    """Steps until `seconds` have passed on rank 0's clock. Keeps the
    outputs of one of the first eight steps, drawn from the seed, in host
    memory (so that the card's peak holds the program's buffers alone);
    the last step's stay on the rank."""
    pick = int(torch.randint(8, (1,), generator=sample.generator(seed ^ 0x5EED, "cpu")))
    t0 = prev = time.perf_counter()
    deadline = t0 + seconds
    step_ms, kept, failed = [], None, 0
    while True:
        ovf, own, stop = rank.step(lambda: rank.rank == 0 and time.perf_counter() >= deadline)
        if len(step_ms) == pick:
            kept = to_device(rank.out, "cpu")
        now = time.perf_counter()
        step_ms.append(1e3 * (now - prev))
        prev = now
        if ovf or own:
            failed += 1  # the state of an overflowed sync is truncated: the window ends
            break
        if stop:
            break
    return {"window_s": prev - t0, "step_ms": step_ms, "steps": len(step_ms), "failed": failed, "kept": kept}


def trace_slices(rank: Rank, slice_s: float, drained_steps: int) -> dict:
    """The traced run's slices after its window: one sync under the
    operation counter, a profiled slice of untouched steps, and profiled
    steps with the phases drained. Every rank makes the same steps:
    rank 0's clock ends the slice, through the step's reduced flags."""
    dev = rank.device
    phases = rank.stepper.PHASES + ("flags",)
    rank.spans = Spans(dev, drained=False)
    rank.ops = OpCounter()
    rank.step()
    ops = rank.ops.ops
    rank.ops = None

    rank.profiled = True
    drain(dev)
    with devtrace.profiled(dev, phases + ("slice",)) as tr:
        with torch.profiler.record_function("slice"):
            t0 = time.perf_counter()
            n, stop = 0, False
            while not stop:  # rank 0's clock ends the slice for every rank, as it ends the window
                _, _, stop = rank.step(lambda: rank.rank == 0 and n >= 1 and time.perf_counter() - t0 >= slice_s)
                n += 1
            drain(dev)
    lo, hi = devtrace.spans_named(tr.events, "slice")[0]
    ops_in = devtrace.device_ops(tr.events, lo, hi)
    host = {p: devtrace.spans_named(tr.events, p) for p in phases}

    rank.spans = Spans(dev, drained=True)
    with devtrace.profiled(dev, phases) as tb:
        for _ in range(drained_steps):
            rank.step()
    rank.profiled = False
    return {"sync_torch_ops": ops, "busy_s": devtrace.union_s(ops_in), "window_s": (hi - lo) / 1e9,
            "slice_steps": n, "device_ops": devtrace.top_device_ops(ops_in),
            "idle_gaps": devtrace.idle_gaps(ops_in, host, lo, hi),
            "phase_device_s": {p: devtrace.device_s_inside(tb.events, p) for p in phases}}


def run_rank(cell: dict, seed: int, seconds: float, trace: bool, comm, device, t0: float) -> dict:
    """One rank's whole run. Returns its record (rank 0's holds what the
    result line needs; numbers of all ranks are reduced into it)."""
    tr = cell["traffic"]
    marks = [("start", time.time() - t0)]
    load_kernels(load_module("traffic", tr["step"]), comm, device)
    marks.append(("kernels", time.time() - t0))
    rank = Rank(cell, comm, device, seed, trace)
    drain(device)
    marks.append(("sample", time.time() - t0))
    tries = rank.establish()
    drain(device)
    if comm is not None:
        comm.all_reduce_flag(True)
    setup_s = time.time() - t0

    rank.spans = Spans(device, drained=trace)
    rank.exchange = []  # the window's syncs alone
    t_win = time.perf_counter()
    win = window(rank, seconds, seed)
    rec = {"n_per_chip": cell["config"]["n"] / rank.ranks, "ranks": rank.ranks, "setup_s": setup_s,
           "on_card": device.type == "cuda", **{k: win[k] for k in ("window_s", "step_ms", "steps", "failed")}}
    if trace:
        rec["spans"] = dict(rank.spans.ms)
        rec["exchange"] = list(rank.exchange) if rank.tally is not None else None
        if not win["failed"]:
            rec["trace"] = trace_slices(rank, tr["trace_slice_s"], tr["trace_drained_steps"])
    drain(device)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    if comm is not None:
        peak = int(comm.all_reduce(torch.tensor(peak, device=device), "max"))
    rec["peak_bytes"] = peak
    last = rank.out
    rank.free()
    checked = [last] if win["kept"] is None or win["kept"]["k"] == last["k"] else \
        [to_device(win["kept"], device), last]
    t_check = time.perf_counter()
    numbers, rec["step"] = rank.stepper.check(rank, checked)
    rec["timing"] = {"setup_marks_s": marks, "setup_s": setup_s, "cold_tries": tries, "retries": rank.retries,
                     "window_and_trace_s": t_check - t_win,
                     "check_s": time.perf_counter() - t_check, "checked_steps": [o["k"] for o in checked]}
    numbers["failed_steps"] = win["failed"]
    rec["numbers"] = numbers
    rec["limits"] = dict(rank.stepper.LIMITS)
    if "trace" in rec:
        if comm is not None:
            gathered = comm.all_gather(torch.tensor([rec["trace"]["busy_s"], rec["trace"]["window_s"]],
                                                    dtype=torch.float64, device=device))
            rec["trace"]["busy_s_ranks"] = gathered[:, 0].tolist()
    return rec


def result_line(cell: dict, rec: dict, trace: bool, device, power_limit=None) -> dict:
    """The run's last line: correct, attempted, failed, metrics, device,
    breakdown (traced), and the compared numbers with their limits last."""
    numbers, limits = rec["numbers"], rec["limits"]
    correct = all(numbers[k] <= limits[k] for k in limits)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": rec["ranks"], "memory_peak_bytes": rec["peak_bytes"]}
    if power_limit is not None:
        dev["power_limit_w"] = power_limit
    line = {"correct": correct, "attempted": rec["steps"], "failed": rec["failed"],
            "metrics": read_metrics(cell["per_layer"] if trace else cell["end_to_end"], rec), "device": dev}
    t = rec.get("trace")
    if trace and t is not None:
        busy = t.get("busy_s_ranks", [t["busy_s"]])
        dev["busy_s"] = sum(busy) / len(busy)
        dev["window_s"] = t["window_s"]
        line["breakdown"] = {"device_ops": t["device_ops"], "idle_gaps": t["idle_gaps"]}
    line["compared"] = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    return line
