"""Peer-local communication: particle exchange, range queries, halo moves
(counterpart of cstone_tpu/parallel/exchange.py, the dense and windowed
protocols;
reference: domain/domaindecomp_mpi.hpp:104-158 exchangeParticles,
domain/exchange_keys.hpp:63-119 exchangeRequestKeys,
halos/exchange_halos.hpp:28-93, focus/exchange_focus.hpp:290-344).

The reference's sparse point-to-point messages become one all_to_all of a
capacity-padded (n_ranks, cap) buffer per protocol round, with per-pair
validity masks and overflow counts in place of dynamic message sizes. Per
rank, memory and traffic scale with the local and surface data, not with
the global particle count.

With `window` = W set, the services and the halo exchange run the
peer-window protocol instead: buffers of 2W+1 rows, row w addressed to
rank me + w - W, moved by 2W ppermute rounds (windowed_exchange), so a
rank's memory and traffic scale with W, not with the rank count; queries
to ranks outside the window are dropped and their callers account for
them (the Domain reports the window it needs).

Every function takes the rank's `RankComm` (parallel/comm.py) where the
JAX package takes an `axis_name`; with comm=None (one rank) all_to_all is
the identity. The JAX scatters with mode="drop" become writes into a
buffer with one spare row or slot, sliced off afterwards. The ragged
protocols are in parallel/ragged.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

from ..ops.primitives import searchsorted, sort_by_key
from ..sfc.keys import remove_key
from .comm import RankComm

__all__ = [
    "all_to_all",
    "windowed_exchange",
    "dest_to_window_row",
    "pack_by_dest",
    "ExchangeRecord",
    "exchange_particles",
    "replay_exchange",
    "range_count_service",
    "range_sum_service",
    "HaloRecord",
    "build_halo_exchange",
    "exchange_halo_field",
]

def all_to_all(x: torch.Tensor, comm: Optional[RankComm]) -> torch.Tensor:
    """Row r of the result = row `rank` of rank r's input. Identity when
    comm is None (one rank)."""
    return x if comm is None else comm.all_to_all(x)


def windowed_exchange(buf: torch.Tensor, comm: Optional[RankComm], window: int, n_ranks: int) -> torch.Tensor:
    """The peer-window counterpart of all_to_all (the peer-scoped sends of
    exchange_focus.hpp:62-96 and exchange_keys.hpp:63-119, bounded by
    findPeersMac, peers.hpp:63-117).

    buf is (2*window+1, ...): row w holds the message for rank
    me + (w - window). Returns a tensor of its shape whose row w holds the
    message FROM rank me + (w - window); rows whose source lies outside
    [0, n_ranks) are zero. Each offset d in 1..min(window, n_ranks-1)
    takes two ppermute rounds, one each way. The buffer itself comes back
    at one rank (comm None or n_ranks 1)."""
    W = int(window)
    if buf.shape[0] != 2 * W + 1:
        raise ValueError(f"a window of {W} needs {2 * W + 1} rows, got {tuple(buf.shape)}")
    if comm is None or n_ranks == 1:
        return buf
    R = n_ranks
    out = torch.zeros_like(buf)
    out[W] = buf[W]  # this rank's own row
    for d in range(1, min(W, R - 1) + 1):
        # my row W+d (for rank me+d) travels +d and lands at me+d as the
        # message from offset -d, its row W-d; and the other way round
        out[W - d] = comm.ppermute(buf[W + d], [(r, r + d) for r in range(R - d)])
        out[W + d] = comm.ppermute(buf[W - d], [(r, r - d) for r in range(d, R)])
    return out


def dest_to_window_row(dest: torch.Tensor, my_rank: int, window: int,
                       n_ranks: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(row, in_window): the window-buffer row of each destination rank and
    whether it lies in the window. Rows of destinations outside it are 0
    (an alias the caller masks)."""
    off = dest.to(torch.int64) - my_rank
    in_win = (off.abs() <= window) & (dest >= 0) & (dest < n_ranks)
    return torch.where(in_win, off + window, 0), in_win


def pack_by_dest(dest: torch.Tensor, valid: torch.Tensor, n_ranks: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(row, col) scatter coordinates packing items into (n_ranks, cap).

    dest is the destination rank per item, NONDECREASING (SFC-ordered
    cells have monotonic owners); invalid items may sit anywhere. col
    counts the valid items of the same destination before this one;
    invalid items get row n_ranks (the spare row the callers drop)."""
    v = valid.to(torch.int64)
    vcum_ex = torch.cumsum(v, 0) - v
    first = torch.searchsorted(dest, dest, right=False)
    return torch.where(valid, dest.to(torch.int64), n_ranks), vcum_ex - vcum_ex[first]


def _scatter_rows(rows: int, cols: int, row: torch.Tensor, col: torch.Tensor, values: torch.Tensor,
                  fill=0) -> torch.Tensor:
    """(rows, cols, ...) buffer holding `values` at (row, col); entries with
    row >= rows or col >= cols are dropped (the JAX mode="drop" scatter)."""
    keep = (row < rows) & (col < cols)
    buf = values.new_full((rows + 1, cols) + tuple(values.shape[1:]), fill)
    buf[torch.where(keep, row, rows), torch.where(keep, col, 0)] = values
    return buf[:rows]


# ---------------------------------------------------------------------------
# particle exchange (domaindecomp_mpi.hpp:104-158)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ExchangeRecord:
    """Replay record of one particle exchange: the counterpart of the
    reference's ExchangeLog (domain/index_ranges.hpp:188-211), exact by
    construction because the all_to_all order is fixed. Index tensors are
    int64 (int32 in the JAX version)."""

    send_idx: torch.Tensor  # (R, move_cap) gather into the pre-exchange sorted arrays
    send_valid: torch.Tensor  # (R, move_cap) bool
    merge_perm: torch.Tensor  # (cap + R*move_cap,) merge-sort permutation
    n_owned: torch.Tensor  # 0-d: valid particles after the exchange
    overflow: torch.Tensor  # 0-d: > 0 if move_cap or cap was exceeded


def exchange_particles(
    keys: torch.Tensor,
    payload: Sequence[torch.Tensor],
    boundaries: torch.Tensor,
    my_rank: int,
    n_local,
    move_cap: int,
    comm: Optional[RankComm],
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...], ExchangeRecord]:
    """Send every particle to the rank whose key range holds it.

    keys: (cap,) locally sorted, invalid slots remove_key; payload: (cap,)
    fields in the same order; boundaries: (R+1,) assignment keys. Every
    rank slices its keys by the boundaries, sends each foreign slice to
    its owner through one (R, move_cap) all_to_all per field, and
    merge-sorts kept and received particles (kept first, then received in
    rank order, a stable sort). Returns (new_keys, new_payload, record);
    slots >= record.n_owned hold remove_key.
    """
    cap = keys.shape[0]
    dev = keys.device
    rk = remove_key(keys.dtype)
    R = boundaries.shape[0] - 1
    n_local = torch.as_tensor(n_local, dtype=torch.int64, device=dev)

    offs = torch.minimum(searchsorted(keys, boundaries, side="left"), n_local)  # (R+1,)
    r_ids = torch.arange(R, device=dev)
    send_counts = torch.where(r_ids == my_rank, 0, offs[1:] - offs[:-1])
    most = send_counts.max()
    overflow = torch.where(most > move_cap, most, 0)

    k = torch.arange(move_cap, device=dev)
    send_valid = k[None, :] < send_counts[:, None]  # (R, move_cap)
    send_idx = torch.where(send_valid, torch.clamp(offs[:-1, None] + k[None, :], 0, cap - 1), cap - 1)

    send_keys = torch.where(send_valid, keys[send_idx], rk)
    recv_keys = all_to_all(send_keys, comm)

    slot = torch.arange(cap, device=dev)
    kept = (slot >= offs[my_rank]) & (slot < offs[my_rank + 1])
    all_keys = torch.cat([torch.where(kept, keys, rk), recv_keys.reshape(-1)])
    all_payload = [torch.cat([p, all_to_all(p[send_idx], comm).reshape(-1)]) for p in payload]
    all_sorted, (merge_perm, *sorted_payload) = sort_by_key(
        all_keys, torch.arange(all_keys.shape[0], device=dev), *all_payload)

    n_owned = (all_keys != rk).sum()
    overflow = torch.maximum(overflow, torch.where(n_owned > cap, n_owned, 0))
    rec = ExchangeRecord(send_idx=send_idx, send_valid=send_valid, merge_perm=merge_perm,
                         n_owned=n_owned, overflow=overflow)
    return all_sorted[:cap], tuple(p[:cap] for p in sorted_payload), rec


def replay_exchange(prop: torch.Tensor, rec: ExchangeRecord, comm: Optional[RankComm]) -> torch.Tensor:
    """Route an extra field through a recorded exchange (reapplySync,
    domain.hpp:335-378). prop is in pre-exchange SORTED order; returns the
    post-exchange owned order, slots >= rec.n_owned unspecified."""
    cap = prop.shape[0]
    recv = all_to_all(prop[rec.send_idx], comm).reshape(-1)
    return torch.cat([prop, recv])[rec.merge_perm][:cap]


# ---------------------------------------------------------------------------
# range query services (exchange_focus.hpp:290-344 exchangeTreeletGeneral)
# ---------------------------------------------------------------------------


def _serve_ranges(req_a: torch.Tensor, req_b: torch.Tensor, served_keys: torch.Tensor,
                  n_served) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-request [start, end) particle index ranges into served_keys."""
    n = torch.as_tensor(n_served, dtype=torch.int64, device=served_keys.device)
    pa = torch.minimum(searchsorted(served_keys, req_a.reshape(-1), side="left"), n)
    pb = torch.minimum(searchsorted(served_keys, req_b.reshape(-1), side="left"), n)
    return pa.reshape(req_a.shape), pb.reshape(req_b.shape)


def _request_rows(dest: torch.Tensor, valid: torch.Tensor, q_cap: int, n_ranks: int, my_rank: int,
                  window: Optional[int]):
    """Request-buffer addressing shared by the services: (rows, row, col,
    ok, exchange, overflow). rows is the buffer's row count (n_ranks dense,
    2*window+1 windowed), row/col the scatter coordinates of each query,
    ok marks the valid queries in the window that fit q_cap, exchange the
    collective over (rows, ...) buffers, and overflow the largest number
    of queries to one rank when that exceeds q_cap. Queries outside the
    window are masked out; the caller decides whether the window must
    grow."""
    row, col = pack_by_dest(dest, valid, n_ranks)
    per_dest = torch.zeros(n_ranks + 1, dtype=torch.int64, device=dest.device)
    per_dest.index_add_(0, row, valid.to(torch.int64))
    most = per_dest[:n_ranks].max()
    overflow = torch.where(most > q_cap, most, 0)
    if window is None:
        return n_ranks, row, col, valid & (col < q_cap), all_to_all, overflow
    W = int(window)
    wrow, in_win = dest_to_window_row(dest, my_rank, W, n_ranks)
    return (2 * W + 1, wrow, col, valid & in_win & (col < q_cap),
            lambda buf, comm: windowed_exchange(buf, comm, W, n_ranks), overflow)


def _send_requests(query_a, query_b, row, col, ok, rows, q_cap, exchange, comm):
    """Ship the (rows, q_cap) request buffers of key ranges [a, b) to
    their owners: the ranges every rank asks of this one."""
    rr = torch.where(ok, row, rows)
    req_a = exchange(_scatter_rows(rows, q_cap, rr, col, query_a), comm)
    req_b = exchange(_scatter_rows(rows, q_cap, rr, col, query_b), comm)
    return req_a, req_b


def range_count_service(
    query_a: torch.Tensor,
    query_b: torch.Tensor,
    dest: torch.Tensor,
    valid: torch.Tensor,
    served_keys: torch.Tensor,
    n_served,
    n_ranks: int,
    q_cap: int,
    comm: Optional[RankComm],
    my_rank: int = 0,
    window: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact particle counts of key ranges [query_a, query_b) owned by
    other ranks (updateCounts, octree_focus_mpi.hpp:205-273): every rank
    asks each range's owner (dest, nondecreasing) to count it against the
    owner's sorted keys; three all_to_all rounds, or with `window` three
    windowed exchanges, whose queries to ranks outside the window count 0.
    Returns (counts (Q,) int64, zero for invalid queries; overflow 0-d)."""
    rows, row, col, ok, exchange, overflow = _request_rows(dest, valid, q_cap, n_ranks, my_rank, window)
    req_a, req_b = _send_requests(query_a, query_b, row, col, ok, rows, q_cap, exchange, comm)
    pa, pb = _serve_ranges(req_a, req_b, served_keys, n_served)
    resp = exchange(pb - pa, comm)  # (rows, q_cap) counts back
    counts = torch.where(ok, resp[torch.clamp(row, max=rows - 1), torch.where(ok, col, 0)], 0)
    return counts, overflow


def range_sum_service(
    query_a: torch.Tensor,
    query_b: torch.Tensor,
    dest: torch.Tensor,
    valid: torch.Tensor,
    served_keys: torch.Tensor,
    n_served,
    served_values: torch.Tensor,
    n_ranks: int,
    q_cap: int,
    comm: Optional[RankComm],
    my_rank: int = 0,
    window: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact per-range sums of the owners' particle values (cap, V): the
    exchange behind the LET mass centers (exchange_focus.hpp:290-344,
    octree_focus_mpi.hpp:369-449 updateCenters). The owner differences a
    prefix sum of its values at the range ends. `window` scopes buffers
    and traffic to the peer window as in range_count_service. Returns
    (sums (Q, V), zero for invalid queries; overflow 0-d)."""
    rows, row, col, ok, exchange, overflow = _request_rows(dest, valid, q_cap, n_ranks, my_rank, window)
    req_a, req_b = _send_requests(query_a, query_b, row, col, ok, rows, q_cap, exchange, comm)
    pa, pb = _serve_ranges(req_a, req_b, served_keys, n_served)

    cap, V = served_values.shape
    n = torch.as_tensor(n_served, dtype=torch.int64, device=served_keys.device)
    live = (torch.arange(cap, device=served_keys.device) < n)[:, None]
    vals = torch.where(live, served_values, 0)
    scan = torch.cat([vals.new_zeros(1, V), torch.cumsum(vals, 0)])
    resp = exchange(scan[pb] - scan[pa], comm)  # (rows, q_cap, V)
    picked = resp[torch.clamp(row, max=rows - 1), torch.where(ok, col, 0)]
    return torch.where(ok[:, None], picked, 0), overflow


# ---------------------------------------------------------------------------
# halo particle exchange (exchange_keys.hpp + exchange_halos.hpp)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class HaloRecord:
    """The halo exchange pattern of one sync: owner-side gathers and
    receiver-side scatters, replayed by every exchange_halo_field call
    (the reference's SendList, halos.hpp:232-251). Rows span the ranks
    (dense: row r is rank r) or the 2*window+1 peer window (row w is rank
    me + w - window); `window` (None: dense) routes the replay."""

    send_idx: torch.Tensor  # (rows, halo_cap) gather into the owned-sorted arrays
    send_valid: torch.Tensor  # (rows, halo_cap) bool
    recv_idx: torch.Tensor  # (rows, halo_cap) scatter into the local layout buffers
    recv_valid: torch.Tensor  # (rows, halo_cap) bool
    overflow: torch.Tensor  # 0-d
    window: Optional[int] = None
    n_ranks: int = 0


def _segment_fill(starts: torch.Tensor, lens: torch.Tensor, out_cap: int):
    """Flatten each row's runs [start, start + len) into a (rows, out_cap)
    index stream: a scatter-max of the run number at each run's first
    output column, a cummax along the row, then start + offset. Returns
    (idx, valid, overflow); overflow is the longest row's total when that
    exceeds out_cap."""
    rows, K = starts.shape
    dev = starts.device
    lens = torch.clamp(lens, min=0)
    inc = torch.cumsum(lens, 1)
    total = inc[:, -1]
    exc = inc - lens
    most = total.max()
    overflow = torch.where(most > out_cap, most, 0)

    ok = (lens > 0) & (exc < out_cap)
    run = torch.arange(K, device=dev).expand(rows, K)
    seg0 = torch.zeros(rows, out_cap + 1, dtype=torch.int64, device=dev)  # column out_cap: dropped
    seg0.scatter_reduce_(1, torch.where(ok, exc, out_cap), run, reduce="amax", include_self=True)
    seg = torch.cummax(seg0[:, :out_cap], dim=1).values

    j = torch.arange(out_cap, device=dev)
    idx = torch.gather(starts, 1, seg) + (j[None, :] - torch.gather(exc, 1, seg))
    valid = j[None, :] < torch.clamp(total, max=out_cap)[:, None]
    return torch.where(valid, idx, 0), valid, overflow


def build_halo_exchange(
    leaf_a: torch.Tensor,
    leaf_b: torch.Tensor,
    leaf_counts: torch.Tensor,
    layout: torch.Tensor,
    halo_request: torch.Tensor,
    owner: torch.Tensor,
    served_keys: torch.Tensor,
    n_served,
    n_ranks: int,
    req_cap: int,
    halo_cap: int,
    comm: Optional[RankComm],
    my_rank: int = 0,
    window: Optional[int] = None,
) -> HaloRecord:
    """One round of the request-keys protocol (exchange_keys.hpp:63-119):
    every rank sends the key ranges [leaf_a, leaf_b) of the leaves it
    requests (halo_request, owner nondecreasing) to their owners, which
    turn them into index ranges of their sorted particles. Returns the
    send and receive pattern; exchange_halo_field moves the particles.
    layout: (cap_leaf+1,) local buffer offsets; leaf_counts: exact
    particle counts per leaf. With `window`, the request and particle
    buffers span the 2*window+1 peer rows; requests to owners outside the
    window are dropped (the caller reports the window it needs)."""
    cap_leaf = leaf_a.shape[0]
    rows, row, col, ok, exchange, overflow = _request_rows(owner, halo_request, req_cap, n_ranks, my_rank,
                                                           window)
    req_a, req_b = _send_requests(leaf_a, leaf_b, row, col, ok, rows, req_cap, exchange, comm)
    pa, pb = _serve_ranges(req_a, req_b, served_keys, n_served)  # (rows, req_cap)

    # owner side: pack the requested ranges into (rows, halo_cap) gathers
    send_idx, send_valid, send_ovf = _segment_fill(pa, pb - pa, halo_cap)

    # receiver side: the responses come back on the rows the requests went
    # out on, so the scatter targets use the request layout
    rr = torch.where(ok, row, rows)
    starts = _scatter_rows(rows, req_cap, rr, col, layout[:cap_leaf].to(torch.int64))
    lens = _scatter_rows(rows, req_cap, rr, col, leaf_counts.to(torch.int64))
    recv_idx, recv_valid, recv_ovf = _segment_fill(starts, lens, halo_cap)

    overflow = torch.maximum(overflow, torch.maximum(send_ovf, recv_ovf))
    return HaloRecord(send_idx=send_idx, send_valid=send_valid, recv_idx=recv_idx, recv_valid=recv_valid,
                      overflow=overflow, window=None if window is None else int(window), n_ranks=n_ranks)


def exchange_halo_field(owned_sorted: torch.Tensor, local_buf: torch.Tensor, rec: HaloRecord,
                        comm: Optional[RankComm]) -> torch.Tensor:
    """Move one field's halo values (exchange_halos.hpp:28-93): owner-side
    gather, one exchange round (an all_to_all, or the record's windowed
    exchange), receiver-side scatter into the layout slots.
    owned_sorted: (cap,) field over the owned particles in key order;
    local_buf: (cap,) field in layout order. Returns a new buffer."""
    cap = owned_sorted.shape[0]
    send = torch.where(rec.send_valid, owned_sorted[torch.clamp(rec.send_idx, 0, cap - 1)], 0)
    if rec.window is None:
        recv = all_to_all(send, comm)
    else:
        recv = windowed_exchange(send, comm, rec.window, rec.n_ranks)
    n = local_buf.shape[0]
    keep = rec.recv_valid & (rec.recv_idx >= 0) & (rec.recv_idx < n)
    out = torch.cat([local_buf, local_buf.new_zeros(1)])  # slot n: dropped
    out[torch.where(keep, rec.recv_idx, n)] = recv.to(out.dtype)
    return out[:n]
