"""The port's spans and counters (cstone_tpu_torch/utils/trace.py) at the
layer boundaries: Domain.sync's ten stages, the cell list's pack, pass
and scatter, every collective of a comm, the passes of the global
tree's and the focus tree's fixed points, mark_macs's walks (the plain
walk on the CPU, one a focus round), the Hilbert codec's calls (the
plain codec on the CPU, `sfc.plain`), the linked-octree builds (the
plain build on the CPU, `octree.plain`), the cornerstone fixed point's
counts, decisions and emissions (the plain functions on the CPU,
`csarray.plain`), the SPH density's pack, pass and scatter with its
route (the plain pass on the CPU, `density.plain`), and find_neighbors'
groups, runs, pass and check with its route (`neighbors.plain` on the
CPU) and the BFS walk's level turns (`bfs.levels`).

Off, a span is one shared null context and a profiler sees none of the
program's ranges; on, the stages open once a sync, in order, nested
under `sync`; each rank thread of run_ranks keeps its own tally, whose
collective calls equal those a wrapper of the comm's methods counts; the
counters equal the loops' passes; and tracing changes no output bit.
2,000 uniform particles in the periodic unit cube, one rank and two
(1,000 a rank), p2p and pool modes, a cold and a warm sync each."""

import contextlib

import numpy as np
import pytest
import torch

from cstone_tpu_torch.domain import Domain
from cstone_tpu_torch.focus import octree_focus
from cstone_tpu_torch.parallel import global_tree, run_ranks
from cstone_tpu_torch.sfc import PERIODIC, hilbert, make_box
from cstone_tpu_torch.traversal import cell_list_neighbor_counts, cell_list_sph_density, macs
from cstone_tpu_torch.traversal import neighbors
from cstone_tpu_torch.tree import csarray, octree
from cstone_tpu_torch.utils import trace

import torch_threads  # noqa: F401  (two intra-op threads per xdist worker)

N, H, LEVEL, CELL_CAP, CAP = 2000, 0.05, 3, 64, 2000
STAGES = ("sync.box", "sync.keys", "sync.tree", "sync.assign", "sync.exchange", "sync.focus", "sync.halos",
          "sync.layout", "sync.halo_exchange", "sync.overflow")
CELLLIST = ("celllist.pack", "celllist.pass", "celllist.scatter")
DENSITY = ("density.pack", "density.pass", "density.scatter")
NEIGHBORS = ("neighbors.groups", "neighbors.runs", "neighbors.pass", "neighbors.check")
COLLECTIVES = ("all_gather", "all_reduce", "all_reduce_flag", "all_to_all", "ragged_all_to_all", "ppermute")
SYNCS = 2  # a cold and a warm sync
CSARRAY_PLAIN = ("compute_node_counts_plain", "rebalance_decision_plain", "rebalance_tree_plain")
FIELDS = ("keys", "x", "y", "z", "h", "start_index", "end_index", "n_with_halos", "sort_order", "layout",
          "halo_flags", "leaf_counts", "overflow", "overflow_detail", "global_ids", "pool_perm")


def _particles():
    rng = np.random.default_rng(17)
    return torch.from_numpy(rng.random((3, N), dtype=np.float32))


def _steps(comm, mode: str, ranks: int):
    """Two syncs of this rank's slice r::ranks (the second drifted, from
    the first's state) and a cell-list pass after each: per sync the
    result's fields and the neighbour counts."""
    r = 0 if comm is None else comm.rank
    xyz = _particles()[:, r::ranks]
    n = xyz.shape[1]
    box = make_box(0.0, 1.0, boundaries=PERIODIC, device="cpu")
    dom = Domain(bucket_size=32, tree_capacity=1024, exchange_mode=mode, comm=comm, device="cpu")
    state = dom.init_state(box=box, boundaries=(1, 1, 1))
    pad = torch.zeros(3, CAP)
    pad[:, :n] = xyz
    h = torch.where(torch.arange(CAP) < n, H, 0.0)
    out = []
    for step in range(SYNCS):
        x, y, z = ((pad + 0.003 * step) % 1.0).unbind(0)
        state, res = dom.sync(state, x, y, z, h, n_local=n)
        counts, _ = cell_list_neighbor_counts(res.keys, res.x, res.y, res.z, res.h, state.box, LEVEL, CELL_CAP,
                                              n_valid=res.n_with_halos)
        out.append({**{f: getattr(res, f) for f in FIELDS}, "counts": counts})
    return out


def _wrap_collectives(comm) -> dict:
    """A CommTally-style count of the comm's collective calls by name,
    made by wrapping its methods."""
    calls = dict.fromkeys(COLLECTIVES, 0)
    for name in COLLECTIVES:
        real = getattr(comm, name)

        def counted(*args, _name=name, _real=real, **kwargs):
            calls[_name] += 1
            return _real(*args, **kwargs)

        setattr(comm, name, counted)
    return calls


class _Passes:
    """Counts the calls of the loop bodies' functions (the global tree's
    update_global_octree, the focus tree's focus_update_once and
    mark_macs), of the plain Hilbert codec's (ihilbert, ihilbert_top,
    decode_hilbert), of the plain linked-octree build (_build_plain) and
    of the fixed point's plain functions (CSARRAY_PLAIN), from every
    thread, while installed."""

    def __init__(self, monkeypatch):
        self.n = {}
        for module, name in ((global_tree, "update_global_octree"), (octree_focus, "focus_update_once"),
                             (macs, "mark_macs"), (hilbert, "ihilbert"), (hilbert, "ihilbert_top"),
                             (hilbert, "decode_hilbert"), (octree, "_build_plain"),
                             *((csarray, name) for name in CSARRAY_PLAIN)):
            self.n[name] = 0
            monkeypatch.setattr(module, name, self._counted(name, getattr(module, name)))

    def _counted(self, name, real):
        def counted(*args, **kwargs):
            self.n[name] += 1  # the ranks take turns between collectives: one thread at a time
            return real(*args, **kwargs)
        return counted


@pytest.fixture(scope="module", params=["p2p", "pool"])
def two_ranks(request):
    """(mode, each rank's (outputs, tally, the wrapper's collective counts)
    traced in its own thread, the loop bodies' calls over both ranks, the
    ranks' untraced outputs)."""
    mode = request.param

    def rank_fn(comm):
        calls = _wrap_collectives(comm)
        with trace.collect() as tally:
            out = _steps(comm, mode, 2)
        return out, tally.read(), calls

    with pytest.MonkeyPatch.context() as mp:
        passes = _Passes(mp)
        traced = run_ranks(2, rank_fn)
    plain = run_ranks(2, lambda comm: _steps(comm, mode, 2))
    return mode, traced, passes.n, plain


def _program_ranges(prof) -> list:
    """(start, end, name) of the host ranges the program's spans opened."""
    names = {"sync", *STAGES, *CELLLIST} | {f"comm.{c}" for c in COLLECTIVES}
    return sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                  for e in prof.profiler.kineto_results.events() if e.name() in names)


def test_off_is_one_null_context_and_the_profiler_sees_no_span():
    assert trace.span("sync") is trace.span("comm.all_reduce")
    trace.count("tree.rounds")  # off: nothing to add to
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _steps(None, "p2p", 1)
    assert _program_ranges(prof) == []
    with trace.collect() as tally:
        assert trace.span("sync") is not trace.span("sync")
    assert tally.read() == {"spans": {}, "counts": {}}
    assert trace.span("sync") is trace.span("sync.box")  # off again after the block


@pytest.mark.parametrize("mode", ["p2p", "pool"])
def test_stages_open_once_a_sync_in_order_under_sync(mode):
    with trace.collect() as tally, \
            torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _steps(None, mode, 1)
    spans = tally.read()["spans"]
    for name in ("sync",) + STAGES + CELLLIST:
        assert spans[name]["calls"] == SYNCS, name
        assert spans[name]["host_s"] > 0.0, name
    assert not any(name.startswith("comm.") for name in spans)  # one rank: no collective
    ranges = _program_ranges(prof)
    syncs = [(s, e) for s, e, name in ranges if name == "sync"]
    assert len(syncs) == SYNCS
    for lo, hi in syncs:
        inside = [(s, e, name) for s, e, name in ranges if lo <= s and e <= hi and name.startswith("sync.")]
        assert tuple(name for _, _, name in inside) == STAGES
    stage_s = sum(spans[name]["host_s"] for name in STAGES)
    assert stage_s <= spans["sync"]["host_s"]


def test_each_rank_thread_keeps_its_own_comm_tally(two_ranks):
    mode, traced, _, _ = two_ranks
    for rank, (_, tally, calls) in enumerate(traced):
        spans = tally["spans"]
        for name in COLLECTIVES:
            got = spans.get(f"comm.{name}", {"calls": 0})["calls"]
            assert got == calls[name], (mode, rank, name)
        assert sum(calls.values()) > 0
        for name in ("sync",) + STAGES + CELLLIST:
            assert spans[name]["calls"] == SYNCS, (mode, rank, name)


def test_counters_equal_the_loops_passes(two_ranks):
    mode, traced, passes, _ = two_ranks
    # every rank makes the same passes: the loops branch on reduced flags
    tree, focus = passes["update_global_octree"], passes["focus_update_once"]
    assert tree > 0 and tree % 2 == 0 and focus > 0 and focus % 2 == 0
    assert passes["mark_macs"] == focus  # one MAC walk a converge round, on the CPU the plain one
    codec = passes["ihilbert"] + passes["ihilbert_top"] + passes["decode_hilbert"]
    assert codec > 0 and codec % 2 == 0
    builds = passes["_build_plain"]
    assert builds > 0 and builds % 2 == 0
    fixed_point = sum(passes[name] for name in CSARRAY_PLAIN)
    assert fixed_point > 0 and fixed_point % 2 == 0
    for _, tally, _ in traced:
        assert tally["counts"] == {"tree.rounds": tree // 2, "focus.rounds": focus // 2,
                                   "macs.plain": focus // 2, "sfc.plain": codec // 2,
                                   "octree.plain": builds // 2, "csarray.plain": fixed_point // 2}, mode


def test_one_rank_counts_tree_rounds_and_no_focus_rounds(monkeypatch):
    passes = _Passes(monkeypatch)
    with trace.collect() as tally:
        _steps(None, "p2p", 1)  # equal buckets at one rank: fast_focus, no converge loop
    assert passes.n["focus_update_once"] == passes.n["mark_macs"] == 0
    codec = passes.n["ihilbert"] + passes.n["ihilbert_top"] + passes.n["decode_hilbert"]
    fixed_point = sum(passes.n[name] for name in CSARRAY_PLAIN)
    assert tally.read()["counts"] == {"tree.rounds": passes.n["update_global_octree"], "sfc.plain": codec,
                                      "octree.plain": passes.n["_build_plain"], "csarray.plain": fixed_point}
    # a count and a decision, then a decision, an emission, a count and a decision a round
    assert fixed_point == 2 * SYNCS + 4 * passes.n["update_global_octree"]
    assert codec > 0 and passes.n["_build_plain"] > 0
    assert passes.n["update_global_octree"] > 0


@pytest.mark.parametrize("mode", ["p2p", "pool"])
def test_one_rank_outputs_bit_equal_with_tracing_on_and_off(mode):
    with trace.collect():
        on = _steps(None, mode, 1)
    off = _steps(None, mode, 1)
    _assert_bit_equal(on, off)


def test_two_rank_outputs_bit_equal_with_tracing_on_and_off(two_ranks):
    _, traced, _, plain = two_ranks
    for (on, _, _), off in zip(traced, plain):
        _assert_bit_equal(on, off)


def _assert_bit_equal(on, off):
    assert len(on) == len(off) == SYNCS
    for a, b in zip(on, off):
        assert a.keys() == b.keys()
        for k in a:
            if a[k] is None:
                assert b[k] is None, k
            else:
                assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def _density(traced: bool):
    """One sync, then cell_list_sph_density with per-particle masses;
    (densities, overflow, the tally's reading or None, the profiler's
    program ranges)."""
    xyz = _particles()
    box = make_box(0.0, 1.0, boundaries=PERIODIC, device="cpu")
    dom = Domain(bucket_size=32, tree_capacity=1024, device="cpu")
    _, res = dom.sync(dom.init_state(box=box, boundaries=(1, 1, 1)), *xyz.unbind(0), torch.full((N,), H))
    m = 0.5 + torch.from_numpy(np.random.default_rng(3).random(N, dtype=np.float32))
    with contextlib.ExitStack() as stack:
        tally = stack.enter_context(trace.collect()) if traced else None
        prof = stack.enter_context(torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]))
        rho, ovf = cell_list_sph_density(res.keys, res.x, res.y, res.z, res.h, box, LEVEL, CELL_CAP,
                                         mass=dom.reapply_sync(res, m), n_valid=res.n_with_halos)
    ranges = sorted((e.start_ns(), e.name()) for e in prof.profiler.kineto_results.events() if e.name() in DENSITY)
    return rho, ovf, None if tally is None else tally.read(), [name for _, name in ranges]


def test_density_opens_its_spans_in_order_and_counts_its_route():
    rho, ovf, tally, ranges = _density(traced=True)
    assert ranges == list(DENSITY)
    assert {n: s["calls"] for n, s in tally["spans"].items()} == dict.fromkeys(DENSITY, 1)
    assert tally["counts"] == {"density.plain": 1}  # the plain pass on the CPU; no density.kernel
    off_rho, off_ovf, _, off_ranges = _density(traced=False)
    assert off_ranges == []
    assert torch.equal(rho, off_rho) and bool(ovf) == bool(off_ovf) is False


@pytest.mark.parametrize("route", ["v2", False, None])
def test_find_neighbors_opens_its_spans_in_order_and_counts_its_route(route, monkeypatch):
    """One sync, then find_neighbors with index lists: the four spans once
    each, in order; one `neighbors.plain` a pass on the CPU (B5's plain
    twin on "v2", the PyTorch route on False and by default); `bfs.levels`
    equal to the BFS walk's level turns (its criterion's calls after the
    root's); the outputs bit-equal with tracing off."""
    xyz = _particles()
    box = make_box(0.0, 1.0, boundaries=PERIODIC, device="cpu")
    dom = Domain(bucket_size=32, tree_capacity=1024, device="cpu")
    state, res = dom.sync(dom.init_state(box=box, boundaries=(1, 1, 1)), *xyz.unbind(0), torch.full((N,), H))
    view = dom.ns_view(res, state.box)
    calls = []
    walk = neighbors.batched_collect_leaves_bfs

    def counted(child_offsets, criterion, *args, **kw):
        return walk(child_offsets, lambda q, n: calls.append(1) or criterion(q, n), *args, **kw)

    monkeypatch.setattr(neighbors, "batched_collect_leaves_bfs", counted)
    kw = dict(ng_max=64, group_size=32, cand_leaf_cap=512, cand_cap=8192, with_indices=True, use_pallas=route)
    with trace.collect() as tally, \
            torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        on = neighbors.find_neighbors(res.x, res.y, res.z, res.h, view, state.box, **kw)
    ranges = sorted((e.start_ns(), e.name()) for e in prof.profiler.kineto_results.events() if e.name() in NEIGHBORS)
    assert [name for _, name in ranges] == list(NEIGHBORS)
    read = tally.read()
    assert {n: c["calls"] for n, c in read["spans"].items()} == dict.fromkeys(NEIGHBORS, 1)
    assert read["counts"] == {"neighbors.plain": 1, "bfs.levels": len(calls) - 1} and len(calls) > 2
    off = neighbors.find_neighbors(res.x, res.y, res.z, res.h, view, state.box, **kw)
    assert torch.equal(on[0], off[0]) and torch.equal(on[1], off[1])
