"""The necessary work of an SPH density pass with per-particle masses
(B2), counted from the inputs whatever the implementation, against the
H100's peaks (roofline.py's: 67 TFLOP/s FP32 outside the tensor cores,
3.35 TB/s HBM3, NVIDIA's H100 SXM data sheet at 700 W):

- each unordered pair within 2h: one squared distance (3 subtractions,
  3 multiplications, 2 additions) and one comparison at each end, 10;
- each end with q < 2: the square root, the scale by 1/h, the q < 1
  comparison, the outer branch's (2 - q)^3 / 4 (a subtraction and 3
  multiplications), the mass product and the sum, 9 (8 and the mass);
- each end with q < 1: the inner branch's 2 more operations;
- each particle: its position, h and mass read once (20 bytes) and its
  density written once (4 bytes), 24 bytes."""

from benchmark.roofline import FP32_PEAK, HBM_PEAK

OPS_PER_PAIR = 8 + 2
OPS_NEAR_END = 8 + 1
OPS_INNER_END = 2
BYTES_PER_PARTICLE = 5 * 4 + 4


def density_pass_ops(pairs: float, near_ends: float, inner_ends: float) -> float:
    return pairs * OPS_PER_PAIR + near_ends * OPS_NEAR_END + inner_ends * OPS_INNER_END


def density_pass_bound_s(pairs: float, near_ends: float, inner_ends: float, particles: float) -> float:
    """The least time the card could take: the larger of the operations
    over the FP32 peak and the bytes over the HBM peak."""
    return max(density_pass_ops(pairs, near_ends, inner_ends) / FP32_PEAK,
               particles * BYTES_PER_PARTICLE / HBM_PEAK)
