"""Minimal SPH density step on top of the Domain (counterpart of
cstone_tpu/models/sph.py; reference: README.md:60-100): every step calls
domain.sync, then computes the density with the fused cell-list stencil.

Only the cell-list path of the JAX `sph_density_step` is ported; its
tree-traversal path (find_neighbors) waits for ROADMAP.md Queue 1, item 12.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

import torch

from ..domain.domain import Domain, DomainState, SyncResult
from ..traversal.celllist import cell_list_sph_density

__all__ = ["SphState", "sph_density_step"]


@dataclass(frozen=True)
class SphState:
    domain: DomainState
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    h: torch.Tensor
    m: torch.Tensor
    n_local: torch.Tensor


def sph_density_step(domain: Domain, state: SphState, cell_level: int = 0,
                     cell_cap: int = 0) -> Tuple[SphState, torch.Tensor, SyncResult]:
    """One density evaluation: sync + fused cell-list density sum.

    Returns (new_state, rho (local_capacity,), sync_result); rho is valid
    in [start_index, end_index). Cell occupancy overflow folds into
    res.overflow for the usual host retry. cell_level/cell_cap are host
    choices (choose_cell_level from max(h), cap from expected occupancy).
    """
    if not (cell_level and cell_cap):
        raise NotImplementedError(
            "the tree-traversal density path is not ported yet "
            "(ROADMAP.md Queue 1, item 12); pass cell_level and cell_cap")
    dstate, res = domain.sync(state.domain, state.x, state.y, state.z, state.h,
                              properties=(state.m,), n_local=state.n_local)
    (m_new,) = res.properties
    rho, cell_ovf = cell_list_sph_density(
        res.keys, res.x, res.y, res.z, res.h, dstate.box, int(cell_level), int(cell_cap),
        mass=m_new, curve=domain.curve, n_valid=res.n_with_halos)
    res = dataclasses.replace(res, overflow=torch.maximum(res.overflow, cell_ovf.to(res.overflow.dtype)))
    co = domain.compact_owned
    new_state = SphState(
        domain=dstate, x=co(res, res.x), y=co(res, res.y), z=co(res, res.z),
        h=co(res, res.h), m=co(res, m_new), n_local=res.end_index - res.start_index)
    return new_state, rho, res
