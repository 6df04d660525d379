"""Spans and counters the harness records around its calls into the
program (traced runs only): host time of a call with the device drained
on both sides, torch operations dispatched inside a block (after the
repository's chip_smoke.OpCounter), and a rank's collective calls and the
bytes it hands them (after the port's multichip.RankTally)."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


def drain(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.current_stream(device).synchronize()


class Spans:
    """Named host-clock spans in ms. `drained=True` waits for the device
    before and after each span, so that a span holds its own device
    work; otherwise spans cost nothing (the untraced run's)."""

    def __init__(self, device, drained: bool):
        self.device, self.drained = device, drained
        self.ms = defaultdict(list)

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.drained:
            yield
            return
        drain(self.device)
        t0 = time.perf_counter()
        yield
        drain(self.device)
        self.ms[name].append(1e3 * (time.perf_counter() - t0))


class OpCounter:
    """Counts the torch operations dispatched inside the block. A
    hand-written kernel's launch is not a torch operation."""

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        counter = self
        self.ops = 0

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                counter.ops += 1
                return func(*args, **(kwargs or {}))

        self._mode = Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self._mode.__exit__(*exc)


COLLECTIVES = ("all_gather", "all_reduce", "all_to_all", "ragged_all_to_all", "ppermute")


class CommTally:
    """Counts a rank's collective calls on its comm (the port's DistComm)
    and the bytes of the tensors it hands them, its own share included,
    by wrapping the comm's methods. `all_reduce_flag` (one int32) counts
    as a call of 4 bytes."""

    def __init__(self, comm):
        self.calls = self.nbytes = 0
        for name in COLLECTIVES + ("all_reduce_flag",):
            real = getattr(comm, name)
            setattr(comm, name, self._wrap(name, real))

    def _wrap(self, name, real):
        def counted(*args, **kwargs):
            self.calls += 1
            t = args[0]
            self.nbytes += 4 if name == "all_reduce_flag" else t.numel() * t.element_size()
            return real(*args, **kwargs)
        return counted

    def read(self):
        return self.calls, self.nbytes
