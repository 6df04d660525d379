"""cstone-tpu's PyTorch/CUDA port: octrees and neighbor search on NVIDIA GPUs.

The JAX package `cstone_tpu` is the reference this package is held
against; this package imports torch and numpy only. Ported so far: the
`Domain` at any number of ranks (SFC keys, cornerstone tree, linked
octree, focus tree, exchanges, halos, layout), the focus tree's building
blocks (focus/, MAC marking, halo discovery), the cell-list neighbor
counts and SPH density, the tiered cell list, the octree neighbor search
and the grid cover, whose inner loops run in hand-written CUDA kernels
(ops/, csrc/), and the clients: the simulation loop, Barnes-Hut gravity,
Halos, particle fields and checkpoints.

SFC keys are unsigned bit patterns held in int32/int64 tensors
(ops/keys64.py). CUDA tensors always run the CUDA kernel; CPU tensors run
its plain PyTorch version.
"""

from .interop import from_numpy_state
from .sfc.box import FIXED, OPEN, PERIODIC, Box, make_box

__version__ = "0.1.0"

__all__ = ["Box", "OPEN", "PERIODIC", "FIXED", "make_box", "from_numpy_state"]
