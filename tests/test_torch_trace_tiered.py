"""The tiered cell list's spans and counters (traversal/tiered.py through
utils/trace.py): inside `trace.collect()` one call opens tiered.partition
once, tiered.pack once a tier and once a tier pair, tiered.same once a
tier, tiered.cross once a tier pair, each around its own work; the
counters equal the tiers, the tier pairs and the ELL slots packed
(cap x 8^level summed over the packs). Outside `collect()` the call
dispatches as many torch operations as before the spans were added, and
tracing changes no output bit, and no B1 pass's output is held through
the next pack (the pass's peak memory, as before the spans). 4,000 Gaussian particles with adaptive
smoothing lengths in the periodic unit cube, three tiers."""

import weakref

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from cstone_tpu_torch.ops.keys64 import usort
from cstone_tpu_torch.sfc import PERIODIC, compute_sfc_keys, make_box
from cstone_tpu_torch.traversal import tiered
from cstone_tpu_torch.utils import trace, workloads

import torch_threads  # noqa: F401  (two intra-op threads per xdist worker)

N = 4000
SPANS = ("tiered.partition", "tiered.pack", "tiered.same", "tiered.cross", "tiered.scatter")
# the torch operations of one call on this input, counted at the commit before the spans
OPS_BEFORE_SPANS = 13722


@pytest.fixture(scope="module")
def call():
    """The tiered call's arguments: key-sorted particles, box, levels, caps."""
    pos = workloads.gaussian_coords(N, (0.0, 1.0) * 3, seed=4)
    h = workloads.adaptive_h(pos, (0.0, 1.0) * 3, 20.0, level=3)
    box = make_box(0.0, 1.0, boundaries=PERIODIC, device="cpu")
    x, y, z = (torch.from_numpy(np.ascontiguousarray(pos[:, i])) for i in range(3))
    keys, order = usort(compute_sfc_keys(x, y, z, box, np.uint64))
    levels = tiered.choose_tier_levels(h, 1.0, max_tiers=3)
    caps, cross = tiered.tier_caps(pos, h, (0.0, 1.0), levels, slack=1.3)
    assert levels == (2, 3, 4), "the input must span three tiers"
    args = (keys, x[order], y[order], z[order], torch.from_numpy(h)[order], box, levels, caps, cross)
    return args, {"n_valid": N}


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope="module")
def traced(call):
    """One call inside trace.collect() under the profiler: (outputs, the
    tally, (start, end, name) of the program's tiered.* ranges)."""
    args, kw = call
    with trace.collect() as tally, \
            torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = tiered.cell_list_neighbor_counts_tiered(*args, **kw)
    ranges = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                    for e in prof.profiler.kineto_results.events() if e.name().startswith("tiered."))
    return out, tally.read(), ranges


def test_spans_once_a_tier_and_a_tier_pair(call, traced):
    args, _ = call
    T, P = len(args[6]), len(args[8])
    _, tally, ranges = traced
    spans = tally["spans"]
    assert set(spans) == set(SPANS)
    want = {"tiered.partition": 1, "tiered.pack": T + P, "tiered.same": T, "tiered.cross": P,
            "tiered.scatter": T + 2 * P + 1}
    assert {n: s["calls"] for n, s in spans.items()} == want
    assert all(s["host_s"] > 0.0 for s in spans.values())
    names = [name for _, _, name in ranges]
    assert names[0] == "tiered.partition" and names[-1] == "tiered.scatter"
    # a tier: pack, B1 pass, scatter; a tier pair: pack of b at level_a, B3 pass, two scatters
    assert names[1:-1] == ["tiered.pack", "tiered.same", "tiered.scatter"] * T + \
        ["tiered.pack", "tiered.cross", "tiered.scatter", "tiered.scatter"] * P


def test_cross_span_holds_the_cross_pass_alone(call, monkeypatch):
    """Every stencil_cross call runs inside a tiered.cross span of its
    own: the span is entered once a call, around it."""
    args, kw = call
    inside = []
    real_cross = tiered.stencil_cross

    def watched(*a, **k):
        inside.append(tally.spans.get("tiered.cross", [0])[0])
        return real_cross(*a, **k)

    monkeypatch.setattr(tiered, "stencil_cross", watched)
    with trace.collect() as tally:
        tiered.cell_list_neighbor_counts_tiered(*args, **kw)
    # the span's tally is written when it closes: the k-th call sees k - 1 closed spans
    assert inside == list(range(len(args[8])))
    assert tally.spans["tiered.cross"][0] == len(args[8])


def test_counters_equal_tiers_pairs_and_slots(call, traced):
    levels, caps, cross = call[0][6:9]
    slots = sum(c * 8 ** lv for c, lv in zip(caps, levels)) + \
        sum(cap * 8 ** levels[a] for (a, _), cap in cross.items())
    assert traced[1]["counts"] == {"tiered.tiers": 3, "tiered.cross_passes": 3, "tiered.slots": slots}


def test_off_dispatches_as_before_and_changes_no_bit(call, traced):
    args, kw = call
    assert trace.span("tiered.cross") is trace.span("tiered.pack")  # off: one shared null context
    with _Ops() as ops:
        off = tiered.cell_list_neighbor_counts_tiered(*args, **kw)
    assert ops.n == OPS_BEFORE_SPANS
    for a, b in zip(traced[0], off):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert not bool(off[1]) and int(off[0].sum()) > 0


def test_no_b1_output_is_held_through_the_next_pack(call, monkeypatch):
    args, kw = call
    outputs, alive = [], []
    real_counts, real_pack = tiered.stencil_counts, tiered._pack_tier

    def counts(*a, **k):
        out = real_counts(*a, **k)
        outputs.append(weakref.ref(out))
        return out

    def pack(*a, **k):
        alive.append(sum(ref() is not None for ref in outputs))
        return real_pack(*a, **k)

    monkeypatch.setattr(tiered, "stencil_counts", counts)
    monkeypatch.setattr(tiered, "_pack_tier", pack)
    tiered.cell_list_neighbor_counts_tiered(*args, **kw)
    assert len(outputs) == 3 and alive == [0] * 6
