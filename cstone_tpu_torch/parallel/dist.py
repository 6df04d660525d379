"""Ranks as processes: a torch.distributed backend of the rank's
communicator (counterpart of cstone_tpu/parallel/mesh.py and of the rank
axis that shard_map binds; reference: MPI_COMM_WORLD in
domain/domaindecomp_mpi.hpp).

`DistComm` has the collectives of parallel/comm.RankComm (`all_gather`,
`all_reduce`, `all_reduce_flag`, `all_to_all`, `ragged_all_to_all`,
`ppermute`) over
an initialised torch.distributed process group, one process a rank, so
the Domain and parallel/exchange.py and parallel/ragged.py take it
unchanged.

The backend is always the caller's choice, never inferred:
  - "nccl": CUDA tensors move over NCCL, one card a rank (rank r on
    cuda:r under `spawn_ranks`, cuda:LOCAL_RANK under torchrun); NCCL
    refuses two ranks on one card, so fewer cards than ranks raises.
  - "gloo": tensors move through host memory. A CUDA operand is copied
    to the host before each collective and its result back to the card;
    `DistComm.staged_bytes` counts the bytes of those copies. Under gloo
    every rank may share one card, or run on the CPU.

`spawn_ranks(n_ranks, fn, *per_rank_args, backend=..., device=...)` is
the counterpart of parallel/comm.run_ranks: it runs fn(comm, *args_r) in
n_ranks fresh processes (the "spawn" start method; a parent holding a
CUDA context must not fork) and returns the results in rank order. The
process group meets at a file store in a fresh temporary directory, so
concurrent callers never race for a port. A failing rank's exception is
re-raised with its traceback; a rank that dies, or a run past its
deadline, kills every rank and raises. `comm_from_env(backend)` builds
the comm of a process that torchrun started (RANK, WORLD_SIZE,
LOCAL_RANK).
"""

from __future__ import annotations

import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
import warnings
from datetime import timedelta
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..utils import trace
from .comm import check_pairs, check_ragged_args, source_of

__all__ = ["DistComm", "spawn_ranks", "comm_from_env", "RankFailed"]

BACKENDS = ("gloo", "nccl")
_OPS = {"sum": "SUM", "max": "MAX", "min": "MIN"}


class RankFailed(RuntimeError):
    """A spawned rank died without reporting, or the run passed its
    deadline."""


class _RemoteTraceback(Exception):
    """The traceback of a rank's exception, as its process printed it."""

    def __init__(self, tb: str):
        super().__init__(tb)
        self.tb = tb

    def __str__(self):
        return self.tb


class DistComm:
    """Rank `rank` of `n_ranks` over the current torch.distributed process
    group, its tensors on `device`. Every rank must call the same
    collectives in the same order, as with MPI; a host flag that selects a
    branch holding a collective is first reduced with `all_reduce_flag`.
    Collectives return fresh tensors on `device`."""

    def __init__(self, rank: int, n_ranks: int, backend: str, device):
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
        self.rank, self.n_ranks = int(rank), int(n_ranks)
        self.backend = backend
        self.device = torch.device(device)
        if backend == "nccl" and self.device.type != "cuda":
            raise ValueError(f"the nccl backend moves CUDA tensors; device {self.device} is not a CUDA device")
        # gloo stages a CUDA operand through host memory
        self._staged = backend == "gloo" and self.device.type == "cuda"
        self.staged_bytes = 0  # bytes copied card -> host and host -> card

    # -- transport -----------------------------------------------------------
    def _send_form(self, t: torch.Tensor) -> torch.Tensor:
        t = t.contiguous()
        if self._staged:
            self.staged_bytes += t.numel() * t.element_size()
            return t.cpu()
        return t

    def _recv_form(self, t: torch.Tensor) -> torch.Tensor:
        if self._staged:
            self.staged_bytes += t.numel() * t.element_size()
            return t.to(self.device)
        return t

    # -- collectives ---------------------------------------------------------
    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """(n_ranks, *t.shape): every rank's `t`, in rank order."""
        with trace.span("comm.all_gather"):
            w = self._send_form(t).reshape(-1)
            out = w.new_empty(self.n_ranks * w.numel())  # the ranks' tensors back to back
            dist.all_gather_into_tensor(out, w)
            return self._recv_form(out).reshape((self.n_ranks,) + tuple(t.shape))

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Elementwise reduction of every rank's `t`, op "sum" | "max" |
        "min"; every rank gets the same bits."""
        with trace.span("comm.all_reduce"):
            if op not in _OPS:
                raise ValueError(f"op must be one of {sorted(_OPS)}, got {op!r}")
            w = self._send_form(t)
            w = w.clone() if w is t else w  # the reduction is in place
            dist.all_reduce(w, op=getattr(dist.ReduceOp, _OPS[op]))
            return self._recv_form(w)

    def all_reduce_flag(self, flag: bool, op: str = "all") -> bool:
        """A host bool reduced over the ranks: op "all" (and) | "any" (or),
        as an int32 min or max."""
        with trace.span("comm.all_reduce_flag"):
            if op not in ("all", "any"):
                raise ValueError(f"op must be 'all' or 'any', got {op!r}")
            wire = self.device if self.backend == "nccl" else torch.device("cpu")
            t = torch.tensor([int(bool(flag))], dtype=torch.int32, device=wire)
            dist.all_reduce(t, op=dist.ReduceOp.MIN if op == "all" else dist.ReduceOp.MAX)
            return bool(t.item())

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """t is (n_ranks, ...), row r addressed to rank r. Returns a fresh
        tensor of t's shape whose row r is row `rank` of rank r's t."""
        with trace.span("comm.all_to_all"):
            if t.shape[0] != self.n_ranks:
                raise ValueError(f"all_to_all needs a leading axis of {self.n_ranks} rows, got {tuple(t.shape)}")
            w = self._send_form(t)
            out = torch.empty_like(w)
            dist.all_to_all_single(out, w)
            return self._recv_form(out)

    def ragged_all_to_all(self, operand: torch.Tensor, output: torch.Tensor, input_offsets: torch.Tensor,
                          send_sizes: torch.Tensor, output_offsets: torch.Tensor,
                          recv_sizes: torch.Tensor) -> torch.Tensor:
        """jax.lax.ragged_all_to_all (see RankComm.ragged_all_to_all): rows
        [input_offsets[r], + send_sizes[r]) of the operand go to rank r and
        land there at output_offsets[r]; a fresh copy of `output` with the
        chunks addressed to this rank written in, every other row kept.

        The sizes must agree across ranks (recv_sizes[r] here equals
        send_sizes[rank] at rank r, as parallel/ragged.ragged_meta makes
        them) and every rank passes an output of the same length. The send
        and receive sizes, clamped to [0, len(output)], are read to the host
        in one (2, n_ranks) transfer; the write offsets travel in one (R,)
        all_to_all; one all_to_all_single with those split sizes moves the
        chunks into a staging buffer, from which each chunk is scattered to
        the offset its sender declared (chunks need not lie back to back:
        ragged_return's offsets have gaps wherever a size was clamped).
        Rows past the operand's end are clamped to its last row, rows past
        the output's end dropped, as in the JAX package's emulation."""
        with trace.span("comm.ragged_all_to_all"):
            check_ragged_args(self, operand, output, input_offsets, send_sizes, output_offsets, recv_sizes)
            dev, out_cap = output.device, output.shape[0]
            write_off = self.all_to_all(output_offsets)  # the offsets the senders declared
            send, recv = torch.stack([send_sizes, recv_sizes]).clamp(0, out_cap).tolist()
            ranks = torch.arange(self.n_ranks, device=dev)

            def rows(sizes, starts):
                """Per row of a staging buffer of chunks of `sizes`: its chunk
                and its place in the chunk + starts[chunk]."""
                sz = torch.tensor(sizes, device=dev)
                chunk = torch.repeat_interleave(ranks, sz, output_size=sum(sizes))
                offs = torch.cumsum(sz, 0) - sz
                return chunk, torch.arange(sum(sizes), device=dev) - offs[chunk] + starts[chunk]

            _, src = rows(send, input_offsets.to(dev))
            w = self._send_form(operand[torch.clamp(src, 0, max(operand.shape[0] - 1, 0))])
            got = w.new_empty((sum(recv),) + tuple(w.shape[1:]))
            dist.all_to_all_single(got, w, output_split_sizes=recv, input_split_sizes=send)
            got = self._recv_form(got)
            _, tgt = rows(recv, write_off.to(dev))
            keep = (tgt >= 0) & (tgt < out_cap)
            out = torch.cat([output, output.new_zeros((1,) + tuple(output.shape[1:]))])  # row out_cap: dropped
            out[torch.where(keep, tgt, out_cap)] = got
            return out[:out_cap]

    def ppermute(self, t: torch.Tensor, pairs: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """jax.lax.ppermute (see RankComm.ppermute): rank dst gets rank
        src's `t` for every (src, dst) in pairs, zeros where no pair names
        it as dst. The rank's send and receive are posted together in one
        batch_isend_irecv (blocking send/recv pairs can deadlock under
        gloo); a rank that no pair names takes no part."""
        with trace.span("comm.ppermute"):
            check_pairs(self, pairs)
            src = source_of(self.rank, pairs)
            dst = next((d for s, d in pairs if s == self.rank), None)
            w = self._send_form(t) if dst is not None else None
            wire = torch.device("cpu") if self._staged else t.device
            got = torch.empty(t.shape, dtype=t.dtype, device=wire) if src is not None else None
            ops = ([dist.P2POp(dist.isend, w, dst)] if dst is not None else []) + \
                  ([dist.P2POp(dist.irecv, got, src)] if src is not None else [])
            if ops:
                for req in dist.batch_isend_irecv(ops):
                    req.wait()
            return torch.zeros_like(t) if src is None else self._recv_form(got)


def _quiet_deprecation() -> None:
    # torch 2.13 marks all_gather_into_tensor deprecated in favour of a
    # name that older releases lack; the port keeps the older name
    warnings.filterwarnings("ignore", message=".*all_gather_into_tensor.* is deprecated", category=FutureWarning)


def _rank_main(rank: int, n_ranks: int, backend: str, device: str, init_file: str, timeout: float,
               fn: Callable, args: tuple, results) -> None:
    """A spawned rank: join the group, run fn(comm, *args), report."""
    try:
        _quiet_deprecation()
        torch.set_num_threads(1)  # the ranks share the host's cores
        if backend == "gloo":
            os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")  # every rank is on this host
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank, world_size=n_ranks,
                                timeout=timedelta(seconds=timeout))
        out = fn(DistComm(rank, n_ranks, backend, dev), *args)
        results.put(("ok", rank, pickle.dumps(out)))
        dist.destroy_process_group()
    except BaseException as e:  # reported to the parent, which re-raises it
        try:
            payload = pickle.dumps(e)
        except Exception:  # an exception that does not pickle: its text stands in
            payload = pickle.dumps(RuntimeError(repr(e)))
        results.put(("err", rank, (payload, traceback.format_exc())))


def spawn_ranks(n_ranks: int, fn: Callable, *per_rank_args: Sequence, backend: str, device,
                timeout: float = 60.0, deadline: Optional[float] = None) -> list:
    """Run fn(comm, *args_r) for r in range(n_ranks), one spawned process
    a rank with a DistComm, and return the n_ranks results in rank order.

    fn must be importable by module and name (a module-level function of a
    module that spawned processes can import), and every argument and
    result picklable: CUDA tensors come back on the device they were on.
    Each of `per_rank_args` holds n_ranks entries; rank r gets entry r.
    backend: "gloo" or "nccl" (see the module docstring). device: where
    every rank's comm puts its tensors under gloo ("cpu", or one card that
    all ranks share); under nccl a CUDA device type, rank r taking cuda:r.
    timeout: seconds a collective may wait (the process group's timeout);
    deadline: seconds for the whole run (None: no limit beyond the
    timeouts). Each rank runs one torch intra-op thread. The first failing
    rank's exception is re-raised with its traceback as the cause; a rank
    that dies without reporting, or a run past the deadline, kills every
    rank and raises RankFailed.
    """
    n_ranks = int(n_ranks)
    if n_ranks < 1:
        raise ValueError(f"n_ranks must be >= 1, got {n_ranks}")
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    for a in per_rank_args:
        if len(a) != n_ranks:
            raise ValueError(f"each per-rank argument needs {n_ranks} entries, got {len(a)}")
    dev = torch.device(device)
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError(f"the nccl backend moves CUDA tensors; device {dev} is not a CUDA device")
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if cards < n_ranks:
            raise ValueError(f"nccl needs one card a rank: {n_ranks} ranks, {cards} cards")
        devices = [f"cuda:{r}" for r in range(n_ranks)]
    else:
        if dev.type == "cuda" and dev.index is None:  # the parent's current card, named for the children
            dev = torch.device("cuda", torch.cuda.current_device())
        devices = [str(dev)] * n_ranks

    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="cstone_ranks_")
    procs = [ctx.Process(target=_rank_main, name=f"rank-{r}", daemon=True,
                         args=(r, n_ranks, backend, devices[r], os.path.join(tmp, "store"), float(timeout),
                               fn, tuple(a[r] for a in per_rank_args), results))
             for r in range(n_ranks)]
    out: List = [None] * n_ranks
    reported = [False] * n_ranks
    end = None if deadline is None else time.monotonic() + float(deadline)
    try:
        for p in procs:
            p.start()
        while not all(reported):
            try:
                kind, r, payload = results.get(timeout=0.2)
            except queue.Empty:
                # a rank whose process ended without its report: dead (its
                # report, if any, was flushed before it exited)
                dead = [r for r, p in enumerate(procs) if p.exitcode is not None and not reported[r]]
                if dead and results.empty():
                    raise RankFailed(f"rank {dead[0]} of {n_ranks} died (exit code {procs[dead[0]].exitcode})"
                                     " without reporting") from None
                if end is not None and time.monotonic() > end:
                    raise RankFailed(f"spawn_ranks({n_ranks}) passed its deadline of {deadline} s") from None
                continue
            if kind == "err":
                exc, tb = pickle.loads(payload[0]), payload[1]
                raise exc from _RemoteTraceback(f"\n\nrank {r} of {n_ranks}, in its process:\n{tb}")
            out[r], reported[r] = pickle.loads(payload), True
        for p in procs:
            p.join(timeout=30)
        return out
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            if p.pid is not None:
                p.join(timeout=10)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)


def comm_from_env(backend: str, device=None, timeout: Optional[float] = None) -> DistComm:
    """The DistComm of a process torchrun started: rank RANK of WORLD_SIZE,
    device cuda:LOCAL_RANK unless `device` names another (gloo only: nccl
    takes the rank's card). Initialises the default process group from
    torchrun's environment (MASTER_ADDR, MASTER_PORT) unless it is
    already initialised; `timeout`: seconds a collective may wait (the
    process group's timeout, which NCCL's watchdog enforces; None: torch's
    default). Under nccl, fewer cards than the ranks on this host
    (LOCAL_WORLD_SIZE) raise in every rank."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    rank, n_ranks = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    dev = torch.device("cuda", local) if device is None else torch.device(device)
    if backend == "nccl":
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        local_ranks = int(os.environ.get("LOCAL_WORLD_SIZE", local + 1))
        if cards < local_ranks:
            raise ValueError(f"nccl needs one card a rank: {local_ranks} ranks on this host, {cards} cards")
    if dev.type == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() <= (dev.index or 0):
            raise RuntimeError(f"device {dev} is not available; pass device='cpu' with backend='gloo'")
        torch.cuda.set_device(dev)
    _quiet_deprecation()
    if not dist.is_initialized():
        kw = {} if timeout is None else {"timeout": timedelta(seconds=timeout)}
        dist.init_process_group(backend, rank=rank, world_size=n_ranks, **kw)
    return DistComm(rank, n_ranks, backend, dev)
