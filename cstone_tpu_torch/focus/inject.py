"""Forced key injection into a cornerstone leaf array (counterpart of
cstone_tpu/focus/inject.py; reference: include/cstone/focus/inject.hpp:52-111).

When the focus rebalance cannot resolve a mandatory key by splitting one
level, the full spanning cover of the key is spliced into the tree: append
the spanning keys of all mandatory intervals, sort, and keep the first of
each run of equal keys.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..ops.keys64 import ule, usort
from ..sfc.keys import node_range, span_sfc_range

__all__ = ["inject_keys"]


def inject_keys(
    leaves: torch.Tensor, n_leaf, mandatory_keys: torch.Tensor, n_keys=None, span_cap: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Insert spanning covers of mandatory keys into the leaf array.

    leaves: (cap_leaf+1,) padded cornerstone keys.
    mandatory_keys: (k,) keys that must exist as node boundaries.
    Returns (new_leaves, new_n_leaf); new_n_leaf may exceed the capacity,
    which the caller checks.
    """
    del n_leaf  # the padding of `leaves` is the terminal key already
    dt = leaves.dtype
    dev = leaves.device
    cap = leaves.shape[0] - 1
    end_key = node_range(dt, 0)
    kk = mandatory_keys.shape[0]

    active = (mandatory_keys != 0) & (mandatory_keys != end_key)
    if n_keys is not None:
        active = active & (torch.arange(kk, device=dev) < n_keys)

    # spanning covers [0, key) and [key, end) give all ancestor boundaries
    key = torch.where(active, mandatory_keys, end_key)
    lo, n_lo = span_sfc_range(torch.zeros_like(key), key, span_cap)
    hi, n_hi = span_sfc_range(key, torch.full_like(key, end_key), span_cap)
    slot = torch.arange(span_cap, device=dev)
    in_lo = slot < torch.where(active, n_lo, 0)[:, None]
    in_hi = slot < torch.where(active, n_hi, 0)[:, None]
    extra = torch.cat([torch.where(in_lo, lo, end_key).reshape(-1),
                       torch.where(in_hi, hi, end_key).reshape(-1)])

    merged, _ = usort(torch.cat([leaves, extra]), stable=False)

    # keep the first of each run; everything >= end_key collapses into the
    # single terminal entry
    keep = torch.cat([merged.new_ones(1, dtype=torch.bool), merged[1:] != merged[:-1]])
    keep = keep & ule(merged, end_key)
    keep_i = keep.to(torch.int64)
    rank = torch.cumsum(keep_i, 0) - keep_i
    out = torch.full((cap + 2,), end_key, dtype=dt, device=dev)
    out[torch.where(keep & (rank <= cap), rank, cap + 1)] = merged
    return out[:cap + 1], keep_i.sum() - 1  # the count holds the leading 0 and the end key
