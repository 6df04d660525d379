"""The device trace of a traced run: torch.profiler over a slice of steps,
reduced to device busy time, the idle share, the device operations that
took most time, the longest idle gaps by what the host was doing, and the
device time of the kernels launched inside a named host span.

Host spans are torch.profiler.record_function ranges the harness opens
around its calls into the program; a device operation belongs to the
span inside which the host call that launched it ran (the profiler's
correlation id ties the two). The idle share is the
arithmetic of the repository's scripts/torch_path_a_steps.py: 1 - union
of the device intervals / wall."""

from __future__ import annotations

import contextlib
from collections import defaultdict

import torch

TOP = 10
NAME_CHARS = 96


@contextlib.contextmanager
def profiled(device, ranges=()):
    """torch.profiler over the block, CPU and (on a card) CUDA activity;
    yields a holder whose `events` is set on exit: (name, on_device,
    start_ns, end_ns) of every host range and device operation. `ranges`
    names the block's record_function ranges, whose device-side images
    the profiler also records: they are no device operations."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.device(device).type == "cuda" else [])
    holder = type("Trace", (), {})()
    with profile(activities=acts) as prof:
        yield holder
    holder.events = _events(prof, set(ranges))


def _events(prof, ranges: set) -> list:
    """(name, on_device, start_ns, end_ns, correlation id): a device
    operation and the host call that launched it share the id."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        start, name = e.start_ns(), e.name()
        on_device = e.device_type() != DeviceType.CPU
        if on_device and name in ranges:
            continue
        out.append((name, on_device, start, start + e.duration_ns(), e.correlation_id()))
    return out


def spans_named(events, name: str) -> list:
    """(start_ns, end_ns) of the host ranges called `name`, in order."""
    return sorted((s, e) for n, dev, s, e, _ in events if not dev and n == name)


def device_ops(events, lo: int, hi: int) -> list:
    """(start_ns, end_ns, name) of the device operations inside [lo, hi]."""
    return sorted((max(s, lo), min(e, hi), n) for n, dev, s, e, _ in events if dev and e > lo and s < hi)


def union_s(ops) -> float:
    """Seconds of the union of the (sorted) operations' intervals."""
    busy, end = 0, 0
    for s, e, _ in ops:
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy / 1e9


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespaces' noise and
    the tail of its template arguments."""
    for noise in ("void ", "at::native::", "(anonymous namespace)::", "std::"):
        name = name.replace(noise, "")
    return name[:NAME_CHARS]


def top_device_ops(ops) -> list:
    total = defaultdict(int)
    for s, e, n in ops:
        total[short_name(n)] += e - s
    return [[n, t / 1e9] for n, t in sorted(total.items(), key=lambda kv: -kv[1])[:TOP]]


def idle_gaps(ops, host_spans: dict, lo: int, hi: int) -> list:
    """The longest stretches of [lo, hi] with no device operation, each
    named after the host span that held its start ("host" where none)."""
    gaps, end = [], lo
    for s, e, _ in ops + [(hi, hi, "")]:
        if s > end:
            gaps.append((end, s))
        end = max(end, e)
    ranges = sorted((s, e, name) for name, spans in host_spans.items() for s, e in spans)

    def named(t):
        hit = [name for s, e, name in ranges if s <= t < e]
        return hit[-1] if hit else "host"

    gaps.sort(key=lambda g: g[0] - g[1])
    return [[named(s), (e - s) / 1e9] for s, e in gaps[:TOP]]


def is_api_call(name: str) -> bool:
    """A CUDA runtime or driver call (cudaLaunchKernel, cuLaunchKernel,
    cudaMemcpyAsync, ...): the host events whose correlation ids the
    device operations carry."""
    return name.startswith("cuda") or (name.startswith("cu") and name[2:3].isupper())


def device_s_inside(events, name: str) -> list:
    """Per host range `name`: the seconds of the device operations that
    host calls inside it launched (matched by correlation id)."""
    device = [(c, e - s) for n, dev, s, e, c in events if dev]
    calls = [(s, c) for n, dev, s, e, c in events if not dev and is_api_call(n)]
    out = []
    for lo, hi in spans_named(events, name):
        launched = {c for s, c in calls if lo <= s < hi}
        out.append(sum(d for c, d in device if c in launched) / 1e9)
    return out
