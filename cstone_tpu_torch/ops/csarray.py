"""The cornerstone fixed point's integer functions of tree/csarray.py as three
hand-written CUDA kernels (csrc/csarray.cu): leaf counts, the rebalance
decision and the emission of the rebalanced keys.

Replaces no TPU kernel: the JAX package runs the fixed point in plain JAX,
and the port's plain functions (compute_node_counts_plain,
rebalance_decision_plain and rebalance_tree_plain of tree/csarray.py, some
600 small torch operations a warm one-card sync) stay the version that CPU
tensors take. tree/csarray chooses by the keys' device; this module only
launches. The source's note has the kernels' bound and design.

Contract, keys (cap + 1,) as int32 (uint32 keys) or int64 (uint64 keys) on
one CUDA device, every result bit-equal to the plain function's over the
whole capacity:
- `node_counts(keys, codes, max_count, n_codes)`: (cap,) int64 counts;
  codes (n,) sorted keys of the same dtype, n_codes None, an int or a 0-d
  int64 tensor on the device.
- `decide(keys, counts, n_nodes, bucket)`: ((cap,) int32 op codes, the
  convergence flag as a 0-d bool tensor); counts (cap,) int64, n_nodes a
  0-d int64 tensor on the device.
- `emit(keys, ops)`: (new keys (cap + 1,), the new node count as a 0-d
  int64 tensor); ops (cap,) int32.
Each launch is counted (`launches()`), and nothing is read back to the host.
Anything else raises, and nothing falls back.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_lib import CudaLibrary, LaunchCounts, check_launch, ptr, register_launches, stream_of

__all__ = ["node_counts", "decide", "emit", "load_library", "launches", "reset_launches"]

_KEY_DTYPES = (torch.int32, torch.int64)
_BUCKET_LIMIT = 1 << 53  # bucket * 512 stays inside int64 in the decision


def _bind(lib: ctypes.CDLL) -> None:
    p, i, n = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.cstone_csarray_counts.argtypes = [p, n, p, n, p, n, n, i, p, p]
    lib.cstone_csarray_counts.restype = i
    lib.cstone_csarray_decide.argtypes = [p, p, p, n, n, i, p, p, p]
    lib.cstone_csarray_decide.restype = i
    lib.cstone_csarray_emit.argtypes = [p, p, p, n, i, p, p]
    lib.cstone_csarray_emit.restype = i


LIBRARY = CudaLibrary("csarray.cu", _bind)
_LAUNCHES = LaunchCounts("counts", "decide", "emit")
register_launches(_LAUNCHES, prefix="csarray_")


def load_library() -> ctypes.CDLL:
    return LIBRARY.load()


def launches() -> dict:
    return _LAUNCHES.snapshot()


def reset_launches() -> None:
    _LAUNCHES.reset()


def _check_keys(keys: torch.Tensor) -> torch.device:
    if keys.dtype not in _KEY_DTYPES:
        raise TypeError(f"the fixed point's kernels take int32 or int64 keys, got {keys.dtype}")
    if keys.dim() != 1 or keys.shape[0] < 2:
        raise ValueError(f"keys must be (cap + 1,) with cap >= 1, got {tuple(keys.shape)}")
    return keys.device


def _check_scalar(t, name: str) -> None:
    if not isinstance(t, torch.Tensor) or t.dtype != torch.int64 or t.dim() != 0:
        raise TypeError(f"{name} must be a 0-d int64 tensor, got {t!r}")


def _check_on(dev: torch.device, **tensors) -> None:
    if dev.type != "cuda":
        raise ValueError(f"the fixed point's kernels launch CUDA kernels; got keys on {dev}")
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} must lie on {dev}, got it on {t.device}")


def node_counts(keys: torch.Tensor, codes: torch.Tensor, max_count: int, n_codes=None) -> torch.Tensor:
    """Particles a leaf, clipped to max_count, by one launch: (cap,) int64."""
    dev = _check_keys(keys)
    if codes.dtype != keys.dtype or codes.dim() != 1:
        raise TypeError(f"codes must be 1-d {keys.dtype}, got {codes.dtype} of shape {tuple(codes.shape)}")
    on_card = {"codes": codes}
    if isinstance(n_codes, torch.Tensor):
        _check_scalar(n_codes, "n_codes")
        on_card["n_codes"] = n_codes
    elif n_codes is not None and not isinstance(n_codes, int):
        raise TypeError(f"n_codes must be None, an int or a 0-d int64 tensor, got {n_codes!r}")
    _check_on(dev, **on_card)

    lib = load_library()
    keys, codes = keys.contiguous(), codes.contiguous()
    cap, n_len = keys.shape[0] - 1, codes.shape[0]
    host_n = n_len if n_codes is None or isinstance(n_codes, torch.Tensor) else n_codes
    counts = torch.empty(cap, dtype=torch.int64, device=dev)
    card_n = n_codes if isinstance(n_codes, torch.Tensor) else None
    err = lib.cstone_csarray_counts(ptr(keys), cap, ptr(codes), n_len, ptr(card_n), host_n, int(max_count),
                                    int(keys.dtype == torch.int64), ptr(counts), stream_of(keys))
    check_launch(err, "cornerstone counts")
    _LAUNCHES.add("counts")
    return counts


def decide(keys: torch.Tensor, counts: torch.Tensor, n_nodes: torch.Tensor, bucket: int):
    """Op codes {0, 1, 8, 64, 512, 4096} a node slot (0 past n_nodes) and
    the convergence flag, by one launch after setting the flag."""
    dev = _check_keys(keys)
    _check_scalar(n_nodes, "n_nodes")
    cap = keys.shape[0] - 1
    if counts.dtype != torch.int64 or tuple(counts.shape) != (cap,):
        raise TypeError(f"counts must be ({cap},) int64, got {counts.dtype} of shape {tuple(counts.shape)}")
    if not -_BUCKET_LIMIT < int(bucket) < _BUCKET_LIMIT:
        raise ValueError(f"bucket {bucket} outside (-2^53, 2^53)")
    _check_on(dev, counts=counts, n_nodes=n_nodes)

    lib = load_library()
    keys, counts = keys.contiguous(), counts.contiguous()
    ops = torch.empty(cap, dtype=torch.int32, device=dev)
    converged = torch.ones((), dtype=torch.bool, device=dev)
    err = lib.cstone_csarray_decide(ptr(keys), ptr(counts), ptr(n_nodes), cap, int(bucket),
                                    int(keys.dtype == torch.int64), ptr(ops), ptr(converged), stream_of(keys))
    check_launch(err, "cornerstone decide")
    _LAUNCHES.add("decide")
    return ops, converged


def emit(keys: torch.Tensor, ops: torch.Tensor):
    """The rebalanced keys (cap + 1,), padded with nodeRange(0), and the new
    node count (the scan's last entry, which may pass cap), by one scan and
    one launch."""
    dev = _check_keys(keys)
    cap = keys.shape[0] - 1
    if ops.dtype != torch.int32 or tuple(ops.shape) != (cap,):
        raise TypeError(f"ops must be ({cap},) int32, got {ops.dtype} of shape {tuple(ops.shape)}")
    _check_on(dev, ops=ops)

    lib = load_library()
    keys, ops = keys.contiguous(), ops.contiguous()
    inc = torch.cumsum(ops, 0, dtype=torch.int64)
    new_keys = torch.empty(cap + 1, dtype=keys.dtype, device=dev)
    err = lib.cstone_csarray_emit(ptr(keys), ptr(ops), ptr(inc), cap, int(keys.dtype == torch.int64),
                                  ptr(new_keys), stream_of(keys))
    check_launch(err, "cornerstone emit")
    _LAUNCHES.add("emit")
    return new_keys, inc[-1]
