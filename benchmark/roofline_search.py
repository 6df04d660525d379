"""The necessary work of a neighbour search that writes lists (B5's list
mode), counted from the inputs whatever the implementation, against the
H100's peaks (roofline.py's: 67 TFLOP/s FP32 outside the tensor cores,
3.35 TB/s HBM3, NVIDIA's H100 SXM data sheet at 700 W):

- each neighbour of each target (the reference's counts summed over the
  owned particles: a list is one-sided, so each end of a pair is its
  own target's work): one squared distance (3 subtractions, 3
  multiplications, 2 additions), the comparison and the count, 10;
- each particle: its position and radius read once (16 bytes), its
  count (4 bytes) and its row of ng_max int64 slots (8 ng_max bytes)
  written once."""

from benchmark.roofline import FP32_PEAK, HBM_PEAK

OPS_PER_HIT = 8 + 2
BYTES_READ, COUNT_BYTES, SLOT_BYTES = 16, 4, 8


def search_bound_s(hits: float, particles: float, ng_max: int) -> float:
    """The least time the card could take: the larger of the operations
    over the FP32 peak and the bytes over the HBM peak."""
    return max(hits * OPS_PER_HIT / FP32_PEAK,
               particles * (BYTES_READ + COUNT_BYTES + SLOT_BYTES * ng_max) / HBM_PEAK)
