"""Client-side dataset helpers (counterpart of cstone_tpu/fields): named
particle fields with conserved/dependent lifetime states."""

from .fields import FieldStates, ParticleFields, get_fields

__all__ = ["FieldStates", "ParticleFields", "get_fields"]
