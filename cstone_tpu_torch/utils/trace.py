"""Spans and counters at the port's layer boundaries, off unless a thread
asks for them.

`span(name)` marks a stage where the work happens (Domain.sync's stages,
the cell list's pack, pass and scatter, each collective of a comm);
`count(name, n)` adds to a named counter (the passes of a fixed-point
loop). Both do nothing until the calling thread enters `collect()`:
off, `span` returns one shared null context, reads no clock, opens no
profiler range and dispatches no torch operation, and `count` returns at
once. On, a span opens `torch.profiler.record_function(name)`, so that it
lands in a running profiler's trace on the clock of the device
operations, nested under its caller's span, and adds its call and host
nanoseconds to the thread's tally. A span never reads a tensor, so it
adds no host synchronisation.

Tallies are per thread: each rank that parallel/comm.run_ranks runs on a
thread of its own keeps its own. `Counts` (named counts behind a lock)
also counts the hand-written kernels' launches (ops/cuda_lib.py).
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch

__all__ = ["Counts", "Tally", "span", "count", "collect"]


class Counts:
    """Named counts that several threads may add to at once."""

    def __init__(self, *names: str):
        self._lock = threading.Lock()
        self._counts = dict.fromkeys(names, 0)

    def add(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + n

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self._counts)

    def reset(self) -> None:
        with self._lock:
            self._counts = dict.fromkeys(self._counts, 0)


class Tally:
    """One thread's spans (calls and host nanoseconds by name) and
    counters while `collect()` is on."""

    def __init__(self):
        self.spans = {}  # name -> [calls, host ns]; only its own thread writes it
        self.counts = Counts()

    def read(self) -> dict:
        """{"spans": {name: {"calls", "host_s"}}, "counts": {name: value}}."""
        return {"spans": {n: {"calls": c, "host_s": ns / 1e9} for n, (c, ns) in self.spans.items()},
                "counts": self.counts.snapshot()}


_NULL = contextlib.nullcontext()
_local = threading.local()


@contextlib.contextmanager
def _timed(name: str, tally: Tally):
    with torch.profiler.record_function(name):
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            entry = tally.spans.setdefault(name, [0, 0])
            entry[0] += 1
            entry[1] += time.perf_counter_ns() - t0


def span(name: str):
    """A context manager around one stage: the shared null context unless
    the calling thread is inside `collect()`."""
    tally = getattr(_local, "tally", None)
    return _NULL if tally is None else _timed(name, tally)


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name` of the calling thread's tally, if it
    collects."""
    tally = getattr(_local, "tally", None)
    if tally is not None:
        tally.counts.add(name, n)


@contextlib.contextmanager
def collect():
    """Trace the calling thread inside the block; yields its fresh Tally.
    The thread's earlier tally, if any, is back in place after it."""
    prev = getattr(_local, "tally", None)
    _local.tally = tally = Tally()
    try:
        yield tally
    finally:
        _local.tally = prev
