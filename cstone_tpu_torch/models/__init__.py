"""Client models on top of the Domain (counterpart of cstone_tpu/models)."""

from .sph import SphState, sph_density_step

__all__ = ["SphState", "sph_density_step"]
