"""Named particle fields with acquire/release lifetime states
(counterpart of cstone_tpu/fields/fields.py; reference:
include/cstone/fields/field_states.hpp:62-104, field_get.hpp:42-89,
data_util.hpp:41).

The reference reuses released buffers to avoid allocation; here
`release` returns a field's tensor to a pool and `acquire` binds a pooled
tensor of matching shape and dtype to a new name, so the storage is
reused. Tensors live on the device the collection was made for.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..utils.device import resolve_device

__all__ = ["FieldStates", "ParticleFields", "get_fields"]

CONSERVED = "conserved"
DEPENDENT = "dependent"
RELEASED = "released"


class FieldStates:
    """Which fields are conserved / dependent / released
    (field_states.hpp:62-104)."""

    def __init__(self):
        self._states: Dict[str, str] = {}

    def add(self, name: str, state: str = DEPENDENT):
        self._states[name] = state

    def set_conserved(self, *names: str):
        for n in names:
            self._states[n] = CONSERVED

    def set_dependent(self, *names: str):
        for n in names:
            self._states[n] = DEPENDENT

    def release(self, *names: str):
        for n in names:
            if self._states.get(n) == CONSERVED:
                raise ValueError(f"cannot release conserved field {n!r}")
            self._states[n] = RELEASED

    def is_allocated(self, name: str) -> bool:
        return self._states.get(name) in (CONSERVED, DEPENDENT)

    def state(self, name: str) -> Optional[str]:
        return self._states.get(name)

    def conserved(self) -> List[str]:
        return [n for n, s in self._states.items() if s == CONSERVED]

    def dependent(self) -> List[str]:
        return [n for n, s in self._states.items() if s == DEPENDENT]


class ParticleFields:
    """A named collection of per-particle tensors with lifetime states.

    The reference's compile-time get<"x","y">(dataset) (field_get.hpp:42-89)
    becomes lookup by name; acquire/release follow FieldStates' memory
    reuse contract. `device` is where new fields are made: the card unless
    the caller names another (device="cpu").
    """

    def __init__(self, n: int, dtype=torch.float32, device=None):
        self.n = int(n)
        self.default_dtype = dtype
        self.device = resolve_device(device)
        self._data: Dict[str, torch.Tensor] = {}
        self._pool: List[torch.Tensor] = []
        self.states = FieldStates()

    # -- allocation -----------------------------------------------------
    def add(self, name: str, value: Optional[torch.Tensor] = None, dtype=None, conserved: bool = False):
        if value is None:
            value = torch.zeros(self.n, dtype=dtype or self.default_dtype, device=self.device)
        self._data[name] = value
        self.states.add(name, CONSERVED if conserved else DEPENDENT)
        return value

    def acquire(self, *names: str, dtype=None):
        """Bind released storage, or fresh zeros, to new names
        (field_states.hpp acquire)."""
        dt = dtype or self.default_dtype
        for name in names:
            reused = None
            for i, buf in enumerate(self._pool):
                if buf.dtype == dt and buf.shape == (self.n,):
                    reused = self._pool.pop(i)
                    break
            self._data[name] = reused if reused is not None else torch.zeros(self.n, dtype=dt, device=self.device)
            self.states.add(name, DEPENDENT)

    def release(self, *names: str):
        self.states.release(*names)
        for name in names:
            buf = self._data.pop(name, None)
            if buf is not None:
                self._pool.append(buf)

    # -- access -----------------------------------------------------------
    def __getitem__(self, name: str) -> torch.Tensor:
        return self._data[name]

    def __setitem__(self, name: str, value: torch.Tensor):
        if name not in self._data:
            self.add(name, value)
        else:
            self._data[name] = value

    def get(self, *names: str) -> Tuple[torch.Tensor, ...]:
        return tuple(self._data[n] for n in names)

    def names(self) -> List[str]:
        return list(self._data.keys())

    def field_index(self, name: str, field_names: Sequence[str]) -> int:
        """getFieldIndex (data_util.hpp:41)."""
        return list(field_names).index(name)


def get_fields(dataset: ParticleFields, *names: str) -> Tuple[torch.Tensor, ...]:
    """get<"x","y">(dataset) (field_get.hpp:42-89)."""
    return dataset.get(*names)
