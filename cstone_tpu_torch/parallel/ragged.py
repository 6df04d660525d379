"""Ragged peer exchange: the range services and the halo exchange over
ragged all-to-alls (counterpart of cstone_tpu/parallel/ragged.py;
reference: peers.hpp:63-117, exchange_focus.hpp:62-96,
exchange_keys.hpp:63-119, exchange_halos.hpp:28-93).

The dense protocols of parallel/exchange.py move (n_ranks, cap) buffers,
mostly empty lanes when a rank has few peers. Here every payload is one
concatenated operand sorted by destination rank and one
`comm.ragged_all_to_all` (the counterpart of jax.lax.ragged_all_to_all),
into a buffer whose capacity is a TOTAL over all senders: sized by the
measured surface, independent of the rank count.

Every protocol has two phases:
  1. a size negotiation, two dense (R, k) int all_to_all rounds
     (`ragged_meta`): clamped sizes and the receivers' write offsets;
  2. the payload, one ragged_all_to_all per field.

A total above its capacity is clamped the same way on both sides and
reported as overflow (the unclamped total), which feeds the host retry
loop as every other capacity does (util/reallocate.hpp semantics).

Every function takes the rank's comm (parallel/comm.RankComm or
parallel/dist.DistComm) where the JAX package takes an `axis_name`; with
comm=None (one rank) each reduces to the single-rank identity. Index
tensors are int64 (int32 in the JAX version). The JAX package's choice
between XLA lowerings of the ragged collective (`_use_native_ragged`,
CSTONE_RAGGED) has no counterpart: each comm has one implementation.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from .comm import RankComm
from .exchange import _segment_fill, _serve_ranges, all_to_all

__all__ = [
    "RaggedMeta",
    "ragged_meta",
    "ragged_send",
    "ragged_return",
    "compact_by_dest",
    "range_count_service_ragged",
    "range_sum_service_ragged",
    "RaggedHaloRecord",
    "build_halo_exchange_ragged",
    "exchange_halo_field_ragged",
]


def _excl_cumsum(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, 0) - x


@dataclass(frozen=True)
class RaggedMeta:
    """Negotiated sizes and offsets of one request -> response round trip,
    each (R,) int64. input_offsets / send_sizes slice my operand per
    destination; output_offsets are my chunks' write offsets in each
    receiver's buffer; recv_sizes / recv_offsets lay out what I receive.
    ret_output_offsets route the response leg: where my response chunks
    land in each requester's operand-aligned buffer. Sizes are clamped so
    that no write passes the receiver's capacity; overflow (0-d) is the
    unclamped total when it did not fit, else 0."""

    input_offsets: torch.Tensor
    send_sizes: torch.Tensor  # clamped to what the receiver accepts
    output_offsets: torch.Tensor
    recv_sizes: torch.Tensor
    recv_offsets: torch.Tensor
    ret_output_offsets: torch.Tensor
    overflow: torch.Tensor


def ragged_meta(send_sizes: torch.Tensor, out_cap: int, comm: Optional[RankComm]) -> RaggedMeta:
    """Negotiate one ragged round for a dest-sorted operand with
    send_sizes[r] items for rank r: two dense all_to_all rounds, (R,) and
    (R, 3)."""
    send_sizes = send_sizes.to(torch.int64)
    input_offsets = _excl_cumsum(send_sizes)
    recv_raw = all_to_all(send_sizes, comm)
    inc = torch.cumsum(recv_raw, 0)
    total = inc[-1]
    recv_offsets = torch.clamp(inc - recv_raw, max=out_cap)
    recv_sizes = torch.clamp(inc, max=out_cap) - recv_offsets
    overflow = torch.where(total > out_cap, total, 0)
    # one (R, 3) round returns the clamped send sizes, my write offsets at
    # each receiver and the response leg's write offsets
    back = all_to_all(torch.stack([recv_sizes, recv_offsets, input_offsets], dim=-1), comm)
    return RaggedMeta(input_offsets=input_offsets, send_sizes=back[:, 0], output_offsets=back[:, 1],
                      recv_sizes=recv_sizes, recv_offsets=recv_offsets, ret_output_offsets=back[:, 2],
                      overflow=overflow)


def _identity_copy(operand: torch.Tensor, out_cap: int, n: torch.Tensor, fill) -> torch.Tensor:
    """One rank: the first n rows of operand at offset 0 of an (out_cap,
    ...) buffer, `fill` elsewhere."""
    j = torch.arange(out_cap, device=operand.device)
    out = operand[torch.clamp(j, max=operand.shape[0] - 1)]
    mask = (j < n).reshape((-1,) + (1,) * (out.dim() - 1))
    return torch.where(mask, out, torch.full((), fill, dtype=out.dtype, device=out.device))


def ragged_send(operand: torch.Tensor, out_cap: int, meta: RaggedMeta, comm: Optional[RankComm],
                fill=0) -> torch.Tensor:
    """Request leg: my dest-sorted operand (N, ...) scatters into every
    receiver's (out_cap, ...) buffer, grouped by source rank in rank
    order; unwritten rows hold `fill`."""
    if comm is None:
        return _identity_copy(operand, out_cap, meta.recv_sizes[0], fill)
    output = operand.new_full((out_cap,) + tuple(operand.shape[1:]), fill)
    return comm.ragged_all_to_all(operand, output, meta.input_offsets, meta.send_sizes, meta.output_offsets,
                                  meta.recv_sizes)


def ragged_return(responses: torch.Tensor, q_len: int, meta: RaggedMeta, comm: Optional[RankComm],
                  fill=0) -> torch.Tensor:
    """Response leg, roles swapped: each server's responses (laid out as
    its request receive buffer) travel back and land at the requester's
    input offsets, so the (q_len, ...) result aligns with the dest-sorted
    request operand. Where a size was clamped, the requester's buffer has
    gaps that keep `fill`."""
    if comm is None:
        return _identity_copy(responses, q_len, meta.send_sizes[0], fill)
    output = responses.new_full((q_len,) + tuple(responses.shape[1:]), fill)
    return comm.ragged_all_to_all(responses, output, meta.recv_offsets, meta.recv_sizes,
                                  meta.ret_output_offsets, meta.send_sizes)


def compact_by_dest(dest: torch.Tensor, valid: torch.Tensor,
                    n_ranks: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(perm, send_sizes, n_valid): one stable sort moves the invalid items
    to the back and keeps the valid items grouped by destination (dest
    NONDECREASING over the valid items); perm gathers the compacted order,
    send_sizes[r] counts the valid items for rank r."""
    key = torch.where(valid, dest.to(torch.int64), n_ranks)
    perm = torch.sort(key, stable=True).indices
    sizes = torch.zeros(n_ranks + 1, dtype=torch.int64, device=dest.device)
    sizes.index_add_(0, key, valid.to(torch.int64))
    sizes = sizes[:n_ranks]
    return perm, sizes, sizes.sum()


def _send_ranges(query_a, query_b, dest, valid, n_ranks, q_total_cap, comm):
    """Compact the valid key ranges [a, b) by destination and ship them to
    their owners: (perm, meta, the ranges every rank asks of this one)."""
    perm, sizes, _ = compact_by_dest(dest, valid, n_ranks)
    qa, qb = query_a[perm], query_b[perm]
    meta = ragged_meta(sizes, q_total_cap, comm)
    return perm, meta, ragged_send(qa, q_total_cap, meta, comm), ragged_send(qb, q_total_cap, meta, comm)


def range_count_service_ragged(query_a, query_b, dest, valid, served_keys, n_served, n_ranks: int,
                               q_total_cap: int, comm: Optional[RankComm]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact particle counts of key ranges [query_a, query_b) owned by
    other ranks (updateCounts, octree_focus_mpi.hpp:205-273), the ragged
    counterpart of exchange.range_count_service: q_total_cap is the TOTAL
    of foreign queries a rank serves. Returns (counts (Q,) int64, zero for
    invalid queries; overflow 0-d)."""
    Q = query_a.shape[0]
    perm, meta, req_a, req_b = _send_ranges(query_a, query_b, dest, valid, n_ranks, q_total_cap, comm)
    pa, pb = _serve_ranges(req_a, req_b, served_keys, n_served)
    back = ragged_return(pb - pa, Q, meta, comm)  # compacted order
    counts = torch.empty_like(back)
    counts[perm] = back
    return torch.where(valid, counts, 0), meta.overflow


def range_sum_service_ragged(query_a, query_b, dest, valid, served_keys, n_served, served_values: torch.Tensor,
                             n_ranks: int, q_total_cap: int,
                             comm: Optional[RankComm]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact per-range sums of the owners' particle values (cap, V) over
    ragged buffers (updateCenters, exchange_focus.hpp:290-344): the owner
    differences a prefix sum of its values at the range ends. Returns
    (sums (Q, V), zero for invalid queries; overflow 0-d)."""
    Q = query_a.shape[0]
    perm, meta, req_a, req_b = _send_ranges(query_a, query_b, dest, valid, n_ranks, q_total_cap, comm)
    pa, pb = _serve_ranges(req_a, req_b, served_keys, n_served)
    cap, V = served_values.shape
    n = torch.as_tensor(n_served, dtype=torch.int64, device=served_keys.device)
    live = (torch.arange(cap, device=served_keys.device) < n)[:, None]
    vals = torch.where(live, served_values, 0)
    scan = torch.cat([vals.new_zeros(1, V), torch.cumsum(vals, 0)])
    back = ragged_return(scan[pb] - scan[pa], Q, meta, comm)
    out = torch.empty_like(back)
    out[perm] = back
    return torch.where(valid[:, None], out, 0), meta.overflow


# ---------------------------------------------------------------------------
# halo exchange (exchange_keys.hpp + exchange_halos.hpp over ragged buffers)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RaggedHaloRecord:
    """The ragged halo pattern of one sync: the owner's flat gather stream,
    the receiver's flat scatter stream and the particle leg's negotiated
    meta. Every exchange_halo_field_ragged call replays it with one
    ragged_all_to_all (the reference's SendList reuse, halos.hpp:232-251);
    the streams are halo_total_cap long, independent of the rank count."""

    gather_idx: torch.Tensor  # (halo_total_cap,) into the owned-sorted arrays
    gather_valid: torch.Tensor  # (halo_total_cap,) bool
    scatter_idx: torch.Tensor  # (halo_total_cap,) into the local layout buffers
    scatter_valid: torch.Tensor  # (halo_total_cap,) bool
    meta: RaggedMeta
    overflow: torch.Tensor  # 0-d
    halo_total_cap: int = 0


def _flat_segment_fill(starts: torch.Tensor, lens: torch.Tensor, out_cap: int):
    """Flatten the runs [start, start + len), in order, into one (out_cap,)
    index stream: (idx, valid, overflow), overflow the runs' total when it
    exceeds out_cap (exchange._segment_fill of one row)."""
    idx, valid, overflow = _segment_fill(starts.to(torch.int64)[None], lens.to(torch.int64)[None], out_cap)
    return idx[0], valid[0], overflow


def build_halo_exchange_ragged(leaf_a, leaf_b, leaf_counts, layout, halo_request, owner, served_keys, n_served,
                               n_ranks: int, req_total_cap: int, halo_total_cap: int,
                               comm: Optional[RankComm]) -> RaggedHaloRecord:
    """The request-keys protocol (exchange_keys.hpp:63-119) over ragged
    buffers. Every rank sends the key ranges [leaf_a, leaf_b) of the
    leaves it requests (halo_request, owner nondecreasing) to their
    owners, which turn them into index ranges of their sorted particles;
    both sides flatten their runs into one stream. Particles arrive
    concatenated by source rank in rank order, which is the receiver's
    owner-sorted request order, so its scatter stream is its own layout
    runs flattened. req_total_cap bounds the halo cells a rank serves,
    halo_total_cap the halo particles it sends and receives; layout:
    (cap_leaf+1,) local buffer offsets, leaf_counts exact counts per
    leaf."""
    dev = leaf_a.device
    perm, meta_req, req_a, req_b = _send_ranges(leaf_a, leaf_b, owner, halo_request, n_ranks, req_total_cap, comm)
    pa, pb = _serve_ranges(req_a, req_b, served_keys, n_served)
    # rows past the requests actually received run no particles
    jq = torch.arange(req_total_cap, device=dev)
    run_len = torch.where(jq < meta_req.recv_sizes.sum(), pb - pa, 0)

    # owner side: the served runs flattened into the particle send stream,
    # and the particles for each client rank (the request chunk it sent)
    gather_idx, gather_valid, send_ovf = _flat_segment_fill(pa, run_len, halo_total_cap)
    src_rank = torch.clamp(torch.searchsorted(meta_req.recv_offsets, jq, right=True) - 1, 0, n_ranks - 1)
    part_sizes = torch.zeros(n_ranks, dtype=torch.int64, device=dev).index_add_(0, src_rank, run_len)
    meta_halo = ragged_meta(part_sizes, halo_total_cap, comm)

    # receiver side: my layout runs of the requested leaves, compacted order
    req_sorted = halo_request[perm]
    starts = torch.where(req_sorted, layout[perm], 0)
    lens = torch.where(req_sorted, leaf_counts[perm].to(torch.int64), 0)
    scatter_idx, scatter_valid, recv_ovf = _flat_segment_fill(starts, lens, halo_total_cap)

    overflow = torch.stack([meta_req.overflow, meta_halo.overflow, send_ovf, recv_ovf]).max()
    return RaggedHaloRecord(gather_idx=gather_idx, gather_valid=gather_valid, scatter_idx=scatter_idx,
                            scatter_valid=scatter_valid, meta=meta_halo, overflow=overflow,
                            halo_total_cap=int(halo_total_cap))


def exchange_halo_field_ragged(owned_sorted: torch.Tensor, local_buf: torch.Tensor, rec: RaggedHaloRecord,
                               comm: Optional[RankComm]) -> torch.Tensor:
    """Move one field's halo values (exchange_halos.hpp:28-93): flat gather,
    one ragged exchange, flat scatter into the layout slots. owned_sorted:
    (cap,) field over the owned particles in key order; local_buf: (cap,)
    field in layout order. Returns a new buffer."""
    cap = owned_sorted.shape[0]
    send = torch.where(rec.gather_valid, owned_sorted[torch.clamp(rec.gather_idx, 0, cap - 1)],
                       owned_sorted.new_zeros(()))
    recv = ragged_send(send, rec.halo_total_cap, rec.meta, comm)
    n = local_buf.shape[0]
    keep = rec.scatter_valid & (rec.scatter_idx >= 0) & (rec.scatter_idx < n)
    out = torch.cat([local_buf, local_buf.new_zeros(1)])  # slot n: dropped
    out[torch.where(keep, rec.scatter_idx, n)] = recv.to(out.dtype)
    return out[:n]
