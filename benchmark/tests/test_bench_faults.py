"""The comparison catches a broken timed path: each run below is a whole
run of a tiny cell on the CPU (set-up, window, comparison, result) past
the harness's look for a card, with the program broken underneath, and
its result must read correct false. The faults a cell of this benchmark
can have: the neighbour pass on positions rounded to bfloat16; a step
that returns its state unchanged; half of the particles left out of the
neighbour pass; an answer altered where it is produced; the exchange
between ranks left out. A sound run of the same cell reads correct
true."""

import dataclasses
import time

import torch

from benchmark import harness
from benchmark.cells import load_cell, load_module

CPU = torch.device("cpu")


def run_one(root, workload="tiny-1.counts", seed=21):
    cell = load_cell(workload, root)
    rec = harness.run_rank(cell, seed, 0.5, False, None, CPU, time.time())
    return harness.result_line(cell, rec, False, CPU)


def run_four(root, patch_comm=None, seed=22):
    from cstone_tpu_torch.parallel import run_ranks

    cell = load_cell("tiny-4.counts", root)

    def rank(comm):
        if patch_comm is not None:
            patch_comm(comm)
        return harness.run_rank(cell, seed, 0.5, False, comm, CPU, time.time())

    recs = run_ranks(4, rank)
    return harness.result_line(cell, recs[0], False, CPU)


def test_sound_runs(tiny_root):
    assert run_one(tiny_root)["correct"]
    assert run_four(tiny_root)["correct"]


def patch_pass(monkeypatch, change):
    step = load_module("traffic", "counts")
    real = step.neighbor_pass

    def broken(rank, res, state):
        return change(real, rank, res, state)

    monkeypatch.setattr(step, "neighbor_pass", broken)


def test_bfloat16_positions_in_the_neighbour_pass(tiny_root, monkeypatch):
    def change(real, rank, res, state):
        rounded = {c: getattr(res, c).to(torch.bfloat16).float() for c in ("x", "y", "z")}
        return real(rank, dataclasses.replace(res, **rounded), state)

    patch_pass(monkeypatch, change)
    line = run_one(tiny_root)
    assert not line["correct"] and line["compared"]["count_mismatch"]["value"] > 0


def test_half_the_particles_left_out(tiny_root, monkeypatch):
    def change(real, rank, res, state):
        return real(rank, dataclasses.replace(res, n_with_halos=res.n_with_halos // 2), state)

    patch_pass(monkeypatch, change)
    line = run_one(tiny_root)
    assert not line["correct"] and line["compared"]["count_mismatch"]["value"] > 0


def test_an_answer_altered(tiny_root, monkeypatch):
    def change(real, rank, res, state):
        counts, ovf = real(rank, res, state)
        counts = counts.clone()
        counts[7] += 1
        return counts, ovf

    patch_pass(monkeypatch, change)
    line = run_one(tiny_root)
    assert not line["correct"] and line["compared"]["count_mismatch"]["value"] >= 1


def test_state_unchanged(tiny_root, monkeypatch):
    from cstone_tpu_torch.domain import Domain

    real, kept = Domain.sync, {}

    def stale(self, state, *args, **kwargs):
        kept.setdefault(id(self), []).append(None)
        if len(kept[id(self)]) <= 3 or "out" not in kept:
            kept["out"] = real(self, state, *args, **kwargs)
        return kept["out"]  # from the third sync on, the same state and result

    monkeypatch.setattr(Domain, "sync", stale)
    line = run_one(tiny_root)
    assert not line["correct"] and line["compared"]["position_mismatch"]["value"] > 0


def test_exchange_left_out(tiny_root, monkeypatch):
    """From the window on, every all_to_all round of the p2p exchange
    hands each rank its own row alone, the others' rows zero: nothing
    crosses between the ranks. (Set-up runs sound: with the fault from
    the start the cold step could not settle its capacities.)"""
    broken = {"on": False}

    def cut(comm):
        real = comm.all_to_all

        def own_row_only(t):
            out = real(t)
            if not broken["on"]:
                return out
            keep = torch.zeros(t.shape[0], dtype=torch.bool)
            keep[comm.rank] = True
            return torch.where(keep.reshape((-1,) + (1,) * (t.dim() - 1)), out, torch.zeros_like(out))

        comm.all_to_all = own_row_only

    real_window = harness.window

    def window(rank, seconds, seed):
        broken["on"] = True
        return real_window(rank, seconds, seed)

    monkeypatch.setattr(harness, "window", window)
    line = run_four(tiny_root, cut)
    assert not line["correct"]
