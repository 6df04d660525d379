"""The in-process collectives layer of the PyTorch port (parallel/comm.py):
values and rank order of every collective, the host-flag reduction, a
failing rank and a rank that stops calling collectives (both surface from
run_ranks, neither hangs), one rank, a comm kept across calls, and launch
counting from 8 rank threads. Exact comparisons throughout."""

import sys
import threading
import time

import numpy as np
import pytest
import torch

from cstone_tpu_torch.ops import cuda_lib
from cstone_tpu_torch.parallel import RankComm, RanksAborted, run_ranks
from cstone_tpu_torch.traversal import traversal
from cstone_tpu_torch.tree import build_linked_octree
from cstone_tpu_torch.tree.csarray import uniform_tree

import torch_threads  # noqa: F401  (two intra-op threads per xdist worker)

R = 8


def _rank_tensor(r):
    # a per-rank (2, 3) tensor whose entries differ in every rank
    return torch.arange(6, dtype=torch.float32).reshape(2, 3) * (r - 3.5) + r


def test_all_gather_in_rank_order():
    out = run_ranks(R, lambda comm: comm.all_gather(_rank_tensor(comm.rank)))
    want = torch.stack([_rank_tensor(r) for r in range(R)])
    for g in out:
        assert g.shape == (R, 2, 3)
        torch.testing.assert_close(g, want, rtol=0, atol=0)
    # every rank gets a tensor of its own
    assert len({g.data_ptr() for g in out}) == R


@pytest.mark.parametrize("op,ref", [("sum", np.sum), ("max", np.max), ("min", np.min)])
def test_all_reduce(op, ref):
    out = run_ranks(R, lambda comm: comm.all_reduce(_rank_tensor(comm.rank), op))
    want = ref(np.stack([_rank_tensor(r).numpy() for r in range(R)]), axis=0)
    for g in out:
        np.testing.assert_array_equal(g.numpy(), want)


def test_all_reduce_rejects_unknown_op():
    with pytest.raises(ValueError, match="op"):
        run_ranks(2, lambda comm: comm.all_reduce(torch.zeros(1), "prod"))


def test_all_reduce_flag():
    def fn(comm):
        odd = comm.rank % 2 == 1
        return (comm.all_reduce_flag(odd, "all"), comm.all_reduce_flag(odd, "any"),
                comm.all_reduce_flag(True, "all"), comm.all_reduce_flag(False, "any"))

    assert run_ranks(R, fn) == [(False, True, True, False)] * R


def test_per_rank_arguments_and_results_in_rank_order():
    out = run_ranks(R, lambda comm, a, b: (comm.rank, comm.n_ranks, a, b), list("abcdefgh"), range(10, 18))
    assert out == [(r, R, "abcdefgh"[r], 10 + r) for r in range(R)]
    with pytest.raises(ValueError, match="entries"):
        run_ranks(R, lambda comm, a: a, [1, 2])


def test_failing_rank_surfaces_and_releases_the_others():
    aborted = []

    def fn(comm):
        comm.all_gather(torch.zeros(1))
        if comm.rank == 3:
            raise KeyError("rank 3 failed")
        try:
            comm.all_gather(torch.zeros(1))  # rank 3 never arrives here
        except RanksAborted:
            aborted.append(comm.rank)
            raise
        return comm.rank

    t0 = time.monotonic()
    with pytest.raises(KeyError, match="rank 3 failed"):
        run_ranks(R, fn, timeout=60.0)
    # the others left their collective through the abort, not the timeout
    assert time.monotonic() - t0 < 30.0
    assert sorted(aborted) == [r for r in range(R) if r != 3]


def test_rank_that_stops_calling_collectives_times_out():
    def fn(comm):
        if comm.rank == 0:
            return "left early"
        return comm.all_reduce_flag(True)

    t0 = time.monotonic()
    with pytest.raises(RanksAborted):
        run_ranks(4, fn, timeout=0.5)
    assert time.monotonic() - t0 < 30.0


def test_one_rank_runs_on_the_calling_thread():
    def fn(comm, a):
        assert isinstance(comm, RankComm) and (comm.rank, comm.n_ranks) == (0, 1)
        t = torch.tensor([1.0, 2.0])
        return (threading.current_thread() is threading.main_thread(), a, comm.all_gather(t),
                comm.all_reduce(t, "max"), comm.all_reduce_flag(False, "any"))

    ((main, a, g, m, f),) = run_ranks(1, fn, ["x"])
    assert main and a == "x" and f is False
    torch.testing.assert_close(g, torch.tensor([[1.0, 2.0]]))
    torch.testing.assert_close(m, torch.tensor([1.0, 2.0]))
    with pytest.raises(ValueError, match="n_ranks"):
        run_ranks(0, fn)


def test_launches_of_8_rank_threads_are_all_counted():
    # 8 ranks each record many launches, taking turns between collectives,
    # and 16 plain threads at once, more than this host's cores, with a
    # short switch interval: no launch is lost, in the counter or in
    # record_launches' list, and mark_levels_log takes every traversal
    per_rank = 2000
    counts = cuda_lib.LaunchCounts("k")
    tree = uniform_tree(np.uint64, 2, 64, device="cpu")
    linked = build_linked_octree(tree.keys, tree.n_nodes)

    def launch_and_mark(r):
        for i in range(per_rank):
            counts.launched("k", (r, i), None)
        marks = traversal.batched_mark(linked.child_offsets, lambda q, n: torch.ones_like(q, dtype=torch.bool),
                                       4, mark_endpoints_only=False)
        return int(marks.sum())

    def rank(comm):
        comm.all_reduce_flag(True)  # start together
        return launch_and_mark(comm.rank)

    def threads(n):
        out = [None] * n
        ts = [threading.Thread(target=lambda r=r: out.__setitem__(r, launch_and_mark(r))) for r in range(n)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60.0)
        assert not any(t.is_alive() for t in ts)
        return out

    interval = sys.getswitchinterval()
    for n, run in ((R, lambda: run_ranks(R, rank)), (2 * R, lambda: threads(2 * R))):
        counts.reset()
        traversal.mark_levels_log = []
        sys.setswitchinterval(1e-6)
        try:
            with cuda_lib.record_launches() as calls:
                marked = run()
        finally:
            sys.setswitchinterval(interval)
            log, traversal.mark_levels_log = traversal.mark_levels_log, None
        assert counts.snapshot() == {"k": n * per_rank}
        assert sorted(args for _, args, _ in calls) == [(r, i) for r in range(n) for i in range(per_rank)]
        assert marked == [int(linked.n_nodes)] * n and log == [2] * n
    counts.reset()
    assert counts.snapshot() == {"k": 0}


def test_one_rank_at_a_time_between_collectives():
    # no two ranks run between the same two collectives at once
    inside, most = [0], [0]
    guard = threading.Lock()

    def fn(comm):
        for _ in range(20):
            with guard:
                inside[0] += 1
                most[0] = max(most[0], inside[0])
            time.sleep(0.001)  # would let another thread in
            with guard:
                inside[0] -= 1
            comm.all_reduce_flag(True)
        return comm.rank

    assert run_ranks(R, fn) == list(range(R))
    assert most[0] == 1


def test_comm_of_an_ended_run_refuses_at_once():
    # a comm kept past its run_ranks call (say inside a Domain) refuses a
    # collective outside run_ranks at once, where it would otherwise wait
    # at a barrier no thread comes to
    kept = run_ranks(2, lambda comm: comm)
    (one,) = run_ranks(1, lambda comm: comm)
    t0 = time.monotonic()
    for comm in kept + [one]:
        with pytest.raises(RuntimeError, match="inside"):
            comm.all_reduce_flag(True)
    assert time.monotonic() - t0 < 5.0


def test_kept_comm_works_in_a_later_call_on_its_ranks_thread():
    kept = run_ranks(R, lambda comm: comm)
    out = run_ranks(R, lambda comm, old: (old.rank, old.all_gather(torch.tensor([old.rank]))), kept)
    for r, (rank, g) in enumerate(out):
        assert rank == r
        np.testing.assert_array_equal(g.numpy(), np.arange(R)[:, None])
    (one,) = run_ranks(1, lambda comm: comm)
    assert run_ranks(1, lambda comm, old: old.all_reduce_flag(True), [one]) == [True]


def test_comm_on_another_ranks_thread_refuses():
    kept = run_ranks(2, lambda comm: comm)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="thread of rank 1"):
        run_ranks(2, lambda comm, old: old.all_gather(torch.zeros(1)), kept[::-1])
    with pytest.raises(RuntimeError, match=r"run_ranks\(2"):
        run_ranks(4, lambda comm, old: old.all_gather(torch.zeros(1)), kept + kept)
    assert time.monotonic() - t0 < 5.0


def test_one_rank_run_inside_a_rank_leaves_its_comm_working():
    # run_ranks(1, ...) on a rank's thread runs there and hands the
    # thread back to its rank: the rank's next collective still meets
    def fn(comm):
        (inner,) = run_ranks(1, lambda c: c.all_reduce(torch.tensor([comm.rank]), "sum"))
        return int(inner), comm.all_reduce(torch.tensor([comm.rank]), "max")

    for r, (inner, m) in enumerate(run_ranks(R, fn)):
        assert inner == r and int(m) == R - 1
