"""Client models on top of the Domain (counterpart of cstone_tpu/models):
the SPH density step, Barnes-Hut gravity and the simulation loop."""

from .nbody import gravity_monopole
from .simulation import SimState, sim_diagnostics, sim_init, sim_step
from .sph import SphState, sph_density, sph_density_step

__all__ = ["SphState", "sph_density_step", "sph_density", "gravity_monopole", "SimState", "sim_init", "sim_step",
           "sim_diagnostics"]
