"""Stage timing on the host clock (counterpart of
cstone_tpu/utils/timing.py; the reference's perf drivers use std::chrono
and CUDA events, test/performance/timing.cuh).

CUDA work is asynchronous: `Timer.stage` waits for the card that holds a
tensor of the stage's result (torch.cuda.synchronize of that device)
before it reads the clock; it reads no element back.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict

import torch

from .tree import tree_leaves

__all__ = ["Timer"]


class Timer:
    def __init__(self):
        self.times: Dict[str, float] = {}

    def stage(self, name: str, fn: Callable, *args, **kwargs) -> Any:
        """Run fn(*args, **kwargs), add its wall time (seconds) to
        times[name] and return its result."""
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        for dev in {leaf.device for leaf in tree_leaves(out) if isinstance(leaf, torch.Tensor)}:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        self.times[name] = self.times.get(name, 0.0) + (time.perf_counter() - t0)
        return out

    def report(self) -> str:
        total = sum(self.times.values())
        lines = [f"{k}: {v * 1000:.1f} ms" for k, v in self.times.items()]
        lines.append(f"total: {total * 1000:.1f} ms")
        return "\n".join(lines)
