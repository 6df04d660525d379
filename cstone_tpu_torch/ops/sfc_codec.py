"""The Hilbert key codec of sfc/encode.py as one hand-written CUDA kernel
a call (csrc/sfc.cu).

Replaces no TPU kernel: the JAX package encodes with plain JAX, and the
port's plain codec (sfc/hilbert.py, one Python loop over the levels of
int64 torch operations over the whole array) stays the version that CPU
tensors take. sfc/encode.py chooses by the input's device; this module
only launches. The source's note has the kernel's bound and design.

Contract: bit-equal to the plain codec.
  - encode_coords(x, y, z, scale, key_dtype): float32 or float64
    coordinates -> keys, the arithmetic of encode._grid_coords followed by
    hilbert.ihilbert; scale holds (m, min * m), the six values
    encode._grid_scale computes on the card.
  - encode_grid(px, py, pz, lmax, levels, out_dtype): int32 or int64 grid
    coordinates (all three of one dtype) -> the top 3*levels bits of their depth-lmax key
    (hilbert.ihilbert with levels == lmax, hilbert.ihilbert_top), stored
    as out_dtype (int32 or int64).
  - decode(keys): int32 (uint32) or int64 (uint64) keys -> three int64
    coordinate arrays (hilbert.decode_hilbert).
Inputs broadcast against each other and are made contiguous; every input
lies on one CUDA device, anything else raises, and nothing falls back.
Empty inputs launch nothing. Each launch is counted (`launches()`: encode
and decode); none reads the card back.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_lib import CudaLibrary, LaunchCounts, check_launch, ptr, stream_of
from .keys64 import torch_key_dtype

__all__ = ["encode_coords", "encode_grid", "decode", "load_library", "launches", "reset_launches"]

_INTS = (torch.int32, torch.int64)


def _bind(lib: ctypes.CDLL) -> None:
    p, i, n = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.cstone_sfc_encode_coords.argtypes = [p, p, p, p, n, i, i, p, p]
    lib.cstone_sfc_encode_coords.restype = i
    lib.cstone_sfc_encode_grid.argtypes = [p, p, p, n, i, i, i, i, p, p]
    lib.cstone_sfc_encode_grid.restype = i
    lib.cstone_sfc_decode.argtypes = [p, n, i, p, p, p, p]
    lib.cstone_sfc_decode.restype = i


LIBRARY = CudaLibrary("sfc.cu", _bind)
_LAUNCHES = LaunchCounts("encode", "decode")


def load_library() -> ctypes.CDLL:
    return LIBRARY.load()


def launches() -> dict:
    return _LAUNCHES.snapshot()


def reset_launches() -> None:
    _LAUNCHES.reset()


def _operands(what: str, dtypes: tuple, *tensors: torch.Tensor) -> list:
    """The tensors, of one dtype among `dtypes` and on one CUDA device,
    broadcast to one shape and contiguous."""
    if tensors[0].dtype not in dtypes or len({t.dtype for t in tensors}) > 1:
        raise TypeError(f"{what} takes inputs of one dtype, {' or '.join(map(str, dtypes))}; "
                        f"got {[t.dtype for t in tensors]}")
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{what} launches a CUDA kernel; got tensors on {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{what}: every input must lie on {dev}, got one on {t.device}")
    if len({t.shape for t in tensors}) > 1:
        tensors = torch.broadcast_tensors(*tensors)
    return [t.contiguous() for t in tensors]


def encode_coords(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor, key_dtype) -> torch.Tensor:
    """Hilbert keys of float coordinates by one launch: x, y, z float32 or
    float64 on one CUDA device; scale (6,) of their dtype there: m per
    dimension, then min * m. Keys in the storage dtype of key_dtype."""
    x, y, z = _operands("encode_coords", (torch.float32, torch.float64), x, y, z)
    kdt = torch_key_dtype(key_dtype)
    if scale.shape != (6,) or scale.dtype != x.dtype or scale.device != x.device:
        raise ValueError(f"scale must be (6,) {x.dtype} on {x.device}, got {tuple(scale.shape)} {scale.dtype} "
                         f"on {scale.device}")
    keys = torch.empty(x.shape, dtype=kdt, device=x.device)
    if keys.numel() == 0:
        return keys
    scale = scale.contiguous()
    err = load_library().cstone_sfc_encode_coords(
        ptr(x), ptr(y), ptr(z), ptr(scale), keys.numel(), int(x.dtype == torch.float64), int(kdt == torch.int64),
        ptr(keys), stream_of(keys))
    check_launch(err, "sfc encode_coords")
    _LAUNCHES.add("encode")
    return keys


def encode_grid(px: torch.Tensor, py: torch.Tensor, pz: torch.Tensor, lmax: int, levels: int,
                out_dtype: torch.dtype) -> torch.Tensor:
    """Top 3*levels bits of the depth-lmax Hilbert key of integer grid
    coordinates (int32 or int64, one CUDA device) by one launch, as
    out_dtype (int32 or int64); 0 <= levels <= lmax <= 31 and 3*levels
    within out_dtype's bits."""
    bits = {torch.int32: 32, torch.int64: 64}.get(out_dtype)
    if bits is None:
        raise TypeError(f"encode_grid writes int32 or int64 keys, got {out_dtype}")
    if not 0 <= levels <= lmax <= 31 or 3 * levels > bits:
        raise ValueError(f"encode_grid takes 0 <= levels <= lmax <= 31 and 3*levels <= {bits}, "
                         f"got levels={levels}, lmax={lmax}")
    px, py, pz = _operands("encode_grid", _INTS, px, py, pz)
    keys = torch.empty(px.shape, dtype=out_dtype, device=px.device)
    if keys.numel() == 0:
        return keys
    err = load_library().cstone_sfc_encode_grid(
        ptr(px), ptr(py), ptr(pz), keys.numel(), int(px.dtype == torch.int64), lmax, levels, int(bits == 64),
        ptr(keys), stream_of(keys))
    check_launch(err, "sfc encode_grid")
    _LAUNCHES.add("encode")
    return keys


def decode(keys: torch.Tensor):
    """int64 grid coordinates (px, py, pz) of Hilbert keys (int32 storage
    of uint32 keys, int64 of uint64, one CUDA device) by one launch."""
    (keys,) = _operands("decode", _INTS, keys)
    out = [torch.empty(keys.shape, dtype=torch.int64, device=keys.device) for _ in range(3)]
    if keys.numel() == 0:
        return tuple(out)
    err = load_library().cstone_sfc_decode(ptr(keys), keys.numel(), int(keys.dtype == torch.int64),
                                           *(ptr(o) for o in out), stream_of(keys))
    check_launch(err, "sfc decode")
    _LAUNCHES.add("decode")
    return tuple(out)
