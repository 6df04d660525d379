"""A rank's communicator, and an in-process backend that runs R ranks as
R threads of one process (counterpart of cstone_tpu/parallel/mesh.py and
of the rank axis that shard_map binds in the JAX package; reference:
MPI_COMM_WORLD in domain/domaindecomp_mpi.hpp).

`RankComm` is what the port's multi-rank code takes where the JAX package
takes an `axis_name`: `all_gather`, `all_reduce`, `all_reduce_flag`,
`all_to_all`, `ragged_all_to_all` and `ppermute`. parallel/dist.py's
`DistComm` has the same collectives over torch.distributed, one process a
rank.
`run_ranks(n_ranks, fn, *per_rank_args)` runs `fn(comm, *args_r)` on one
thread per rank; the ranks meet at a barrier inside each collective.
Each collective of both comms opens a `comm.<name>` span
(utils/trace.py), which holds the rank's wait for its peers.

A comm is rank r's handle, not a connection: its collectives run inside
any run_ranks(n_ranks, ...) call, on the thread that runs rank r there.
An object that keeps it (a Domain) can therefore live across calls, as
a rank's objects live across steps under MPI. Outside run_ranks, or on
another rank's thread, a collective raises at once.

One rank at a time runs between two collectives: a rank holds a baton
from its start until it enters a collective, and takes it back on
leaving. torch releases the interpreter lock around every operation, and
threads that dispatch many small operations at once then mostly wait on
each other for that lock: on an 8-core host, 8 threads of 20,000 small
additions each took 7.2 s against 0.11 s for one thread's 20,000, and on
an H100 host an 8-rank pool sync of 1M particles took 1.2-1.3 s with the
ranks in turns against 6.8 s with all of them at once. The card still
overlaps the ranks' kernels, which each rank only enqueues.

On one CUDA device every rank enqueues on the device's current stream: a
tensor one rank enqueued before a barrier is, in stream order, ready for
the kernels another rank enqueues after it. Collectives return fresh
tensors (a stack or a reduction of the deposited ones); no rank writes
into another rank's tensor.

A rank that raises aborts the barrier: the other ranks leave their
collective with `RanksAborted`, and `run_ranks` re-raises the first
rank's own exception. A barrier that waits longer than `timeout` seconds
also aborts, so a rank that stops calling collectives cannot hang the
others.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

from ..utils import trace

__all__ = ["RankComm", "RanksAborted", "run_ranks", "check_ragged_args", "check_pairs", "source_of"]

_REDUCE = {
    "sum": lambda s: s.sum(dim=0),
    "max": lambda s: s.amax(dim=0),
    "min": lambda s: s.amin(dim=0),
}

# the run_ranks call and the rank the current thread runs, and whether it
# holds its call's baton
_current = threading.local()


class RanksAborted(RuntimeError):
    """Raised in a rank whose collective was abandoned: another rank
    failed, or the barrier timed out."""


class _Barrier:
    """A reusable barrier of n threads with a timeout, whose completed
    rounds stay complete: abort() and a timeout fail only the threads of
    the round still filling. (threading.Barrier also fails a thread of a
    completed round that has not woken up yet when abort() comes.)"""

    def __init__(self, n: int, timeout: float):
        self._cond = threading.Condition()
        self._n, self._timeout = n, timeout
        self._count, self._round, self._broken = 0, 0, False

    def wait(self) -> None:
        with self._cond:
            if self._broken:
                raise threading.BrokenBarrierError
            mine = self._round
            self._count += 1
            if self._count == self._n:
                self._count, self._round = 0, self._round + 1
                self._cond.notify_all()
                return
            if not self._cond.wait_for(lambda: self._round != mine or self._broken, self._timeout):
                self._broken = True  # timed out: fail the round for everyone
                self._cond.notify_all()
            if self._round == mine:
                raise threading.BrokenBarrierError

    def abort(self) -> None:
        with self._cond:
            self._broken = True
            self._cond.notify_all()


class _Group:
    """The state the ranks of one run_ranks call share."""

    def __init__(self, n_ranks: int, timeout: float):
        self.n_ranks = n_ranks
        self.barrier = _Barrier(n_ranks, timeout)
        self.slots: List[Any] = [None] * n_ranks
        self.baton = threading.Lock()


def _enter(group: _Group, rank: int):
    """Make this thread rank `rank` of `group`; returns what it ran before."""
    prev = getattr(_current, "group", None), getattr(_current, "rank", None), getattr(_current, "holding", False)
    _current.group, _current.rank, _current.holding = group, rank, False
    return prev


def _leave(prev) -> None:
    _pass_baton()
    _current.group, _current.rank, _current.holding = prev


def _take_baton() -> None:
    _current.group.baton.acquire()
    _current.holding = True


def _pass_baton() -> None:
    if getattr(_current, "holding", False):
        _current.holding = False
        _current.group.baton.release()


def check_ragged_args(comm, operand, output, *vectors) -> None:
    """The shapes ragged_all_to_all takes: operand (N, ...) and output
    (out_cap, ...) of one row shape and dtype, four (n_ranks,) vectors."""
    if operand.shape[1:] != output.shape[1:] or operand.dtype != output.dtype:
        raise ValueError(f"operand {tuple(operand.shape)} {operand.dtype} and output {tuple(output.shape)} "
                         f"{output.dtype} need one row shape and dtype")
    for v in vectors:
        if v.shape != (comm.n_ranks,):
            raise ValueError(f"offset and size vectors need shape ({comm.n_ranks},), got {tuple(v.shape)}")


def check_pairs(comm, pairs) -> None:
    """ppermute's pairs: (src, dst) ranks of the comm, no rank twice a
    source or twice a destination."""
    src, dst = [p[0] for p in pairs], [p[1] for p in pairs]
    if any(not 0 <= r < comm.n_ranks for r in src + dst):
        raise ValueError(f"ppermute pairs name ranks outside [0, {comm.n_ranks}): {list(pairs)}")
    if len(set(src)) != len(src) or len(set(dst)) != len(dst):
        raise ValueError(f"ppermute pairs name a rank twice as source or as destination: {list(pairs)}")


def source_of(rank: int, pairs) -> Optional[int]:
    """The rank that sends to `rank` under ppermute's pairs, or None."""
    return next((s for s, d in pairs if d == rank), None)


def land_chunk(output, operand, in_off, size, write_off) -> torch.Tensor:
    """`output` with rows [write_off, write_off + size) taken from operand
    rows [in_off, in_off + size), by one gather of output's length; rows
    past either end are clamped (operand) or dropped (output), as in the
    JAX package's emulation of ragged_all_to_all. All four are tensors on
    output's device; nothing is read on the host."""
    if operand.shape[0] == 0:
        return output
    j = torch.arange(output.shape[0], device=output.device)
    k = j - write_off
    take = (k >= 0) & (k < size)
    src = torch.clamp(in_off + k, 0, operand.shape[0] - 1)
    return torch.where(take.reshape((-1,) + (1,) * (output.dim() - 1)), operand[src], output)


class RankComm:
    """Rank `rank` of `n_ranks`: the collectives of the in-process backend.

    Every rank must call the same collectives in the same order, as with
    MPI; a host flag that selects a branch holding a collective is first
    reduced with `all_reduce_flag`.
    """

    def __init__(self, rank: int, n_ranks: int):
        self.rank = int(rank)
        self.n_ranks = int(n_ranks)

    def _group(self) -> _Group:
        group = getattr(_current, "group", None)
        if group is None or group.n_ranks != self.n_ranks or _current.rank != self.rank:
            raise RuntimeError(f"rank {self.rank} of {self.n_ranks}: its collectives run inside "
                               f"run_ranks({self.n_ranks}, ...), on the thread of rank {self.rank}")
        return group

    def _wait(self, group: _Group) -> None:
        _pass_baton()
        try:
            group.barrier.wait()
        except threading.BrokenBarrierError:
            raise RanksAborted(f"rank {self.rank}: a collective was abandoned "
                               "(another rank failed, or the barrier timed out)") from None
        _take_baton()

    def _exchange(self, value) -> list:
        """Every rank's `value`, in rank order."""
        group = self._group()
        group.slots[self.rank] = value
        self._wait(group)  # every rank has deposited
        out = list(group.slots)
        self._wait(group)  # every rank has read: the slots may be reused
        return out

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """(n_ranks, *t.shape): every rank's `t`, in rank order."""
        with trace.span("comm.all_gather"):
            return torch.stack(self._exchange(t))

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Elementwise reduction of every rank's `t`, op "sum" | "max" |
        "min". Every rank reduces in rank order, so all get the same bits."""
        with trace.span("comm.all_reduce"):
            if op not in _REDUCE:
                raise ValueError(f"op must be one of {sorted(_REDUCE)}, got {op!r}")
            return _REDUCE[op](self.all_gather(t))

    def all_reduce_flag(self, flag: bool, op: str = "all") -> bool:
        """A host bool reduced over the ranks: op "all" (and) | "any" (or)."""
        with trace.span("comm.all_reduce_flag"):
            if op not in ("all", "any"):
                raise ValueError(f"op must be 'all' or 'any', got {op!r}")
            flags = [bool(f) for f in self._exchange(bool(flag))]
            return all(flags) if op == "all" else any(flags)

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """t is (n_ranks, ...), row r addressed to rank r. Returns a fresh
        tensor of t's shape whose row r is row `rank` of rank r's t
        (jax.lax.all_to_all with split and concat axis 0, tiled)."""
        with trace.span("comm.all_to_all"):
            if t.shape[0] != self.n_ranks:
                raise ValueError(f"all_to_all needs a leading axis of {self.n_ranks} rows, got {tuple(t.shape)}")
            return torch.stack([u[self.rank] for u in self._exchange(t)])

    def ragged_all_to_all(self, operand: torch.Tensor, output: torch.Tensor, input_offsets: torch.Tensor,
                          send_sizes: torch.Tensor, output_offsets: torch.Tensor,
                          recv_sizes: torch.Tensor) -> torch.Tensor:
        """jax.lax.ragged_all_to_all on rank `rank`: rows [input_offsets[r],
        + send_sizes[r]) of this rank's operand go to rank r and land there
        at output_offsets[r], the offset this rank (the sender) declares.
        Returns a fresh copy of `output` with every chunk addressed to this
        rank written in; every other row keeps its value. The offset and
        size vectors are (n_ranks,) integer tensors; recv_sizes[r], the
        size of rank r's chunk, is the receiver's copy of what rank r
        sends and is not read here (the senders' sizes are). Each sender's
        chunk is read with one device-side gather of output's length (no
        host read, no (n_ranks, out_cap) buffer); a chunk longer than the
        output or past its end is cut there, as in the JAX package's
        emulation (cstone_tpu/parallel/ragged.py)."""
        with trace.span("comm.ragged_all_to_all"):
            check_ragged_args(self, operand, output, input_offsets, send_sizes, output_offsets, recv_sizes)
            out = output.clone()
            for op, i_off, size, w_off in self._exchange((operand, input_offsets, send_sizes, output_offsets)):
                out = land_chunk(out, op, i_off[self.rank], size[self.rank], w_off[self.rank])
            return out

    def ppermute(self, t: torch.Tensor, pairs: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """jax.lax.ppermute: for every (src, dst) in pairs, rank dst gets
        rank src's `t`; a rank that no pair names as dst gets zeros. Every
        rank passes the same pairs and a `t` of one shape and dtype; no
        rank is named twice as src or twice as dst. Returns a fresh
        tensor."""
        with trace.span("comm.ppermute"):
            check_pairs(self, pairs)
            src = source_of(self.rank, pairs)
            got = self._exchange(t)
            return torch.zeros_like(t) if src is None else got[src].clone()


def run_ranks(n_ranks: int, fn: Callable, *per_rank_args: Sequence, timeout: float = 600.0) -> list:
    """Run fn(comm, *args_r) for r in range(n_ranks), one thread per rank,
    and return the n_ranks results in rank order.

    Each of `per_rank_args` is a sequence of n_ranks entries; rank r gets
    entry r of each. The ranks take turns between collectives (see the
    module docstring). If a rank raises, the others are released from
    their collectives and the first rank's exception is re-raised here. A
    collective that waits longer than `timeout` seconds aborts all of
    them. With n_ranks == 1, fn runs on the calling thread.
    """
    n_ranks = int(n_ranks)
    if n_ranks < 1:
        raise ValueError(f"n_ranks must be >= 1, got {n_ranks}")
    for a in per_rank_args:
        if len(a) != n_ranks:
            raise ValueError(f"each per-rank argument needs {n_ranks} entries, got {len(a)}")
    group = _Group(n_ranks, timeout)
    args = [tuple(a[r] for a in per_rank_args) for r in range(n_ranks)]
    if n_ranks == 1:
        prev = _enter(group, 0)
        try:
            return [fn(RankComm(0, 1), *args[0])]
        finally:
            _leave(prev)

    results: List[Any] = [None] * n_ranks
    errors: List[BaseException] = []  # in the order the ranks failed
    lock = threading.Lock()

    def body(r: int) -> None:
        prev = _enter(group, r)
        try:
            _take_baton()
            results[r] = fn(RankComm(r, n_ranks), *args[r])
        except BaseException as e:  # re-raised by run_ranks on the calling thread
            with lock:
                errors.append(e)
            _pass_baton()
            group.barrier.abort()
        finally:
            _leave(prev)

    threads = [threading.Thread(target=body, args=(r,), name=f"rank-{r}", daemon=True)
               for r in range(n_ranks)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        # a rank's own failure, not the RanksAborted it caused in the others
        first = next((e for e in errors if not isinstance(e, RanksAborted)), errors[0])
        raise first
    return results
