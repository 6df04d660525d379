"""The necessary work of a neighbour pass and the H100's peaks (NVIDIA's
H100 SXM data sheet, 700 W: 67 TFLOP/s FP32 outside the tensor cores,
3.35 TB/s HBM3). The work is counted from the inputs, whatever the
implementation: each unordered pair within the search radius costs one
squared distance (3 subtractions, 3 multiplications, 2 additions) and
one comparison at each end; each particle's position and radius are
read once (16 bytes) and its count written once (4 bytes)."""

FP32_PEAK = 67e12
HBM_PEAK = 3.35e12
OPS_PER_PAIR = 8 + 2
BYTES_READ, BYTES_WRITTEN = 16, 4


def neighbor_pass_bound_s(pairs: float, particles: float) -> float:
    """The least time the card could take: the larger of the operations
    over the FP32 peak and the bytes over the HBM peak."""
    return max(pairs * OPS_PER_PAIR / FP32_PEAK, particles * (BYTES_READ + BYTES_WRITTEN) / HBM_PEAK)
