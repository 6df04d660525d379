"""Multi-step simulation loop over the Domain (counterpart of
cstone_tpu/models/simulation.py): the reference's client usage pattern
(README.md:60-100: sync, find neighbours, compute forces, integrate,
repeat) as a kick-drift-kick leapfrog with a conservative short-range
pair force.

The force is a repulsive Hookean contact, F_ij = k (2h_i - r) r_hat for
r < 2h_i (potential k/2 (2h - r)^2), which conserves total momentum and
energy up to the integrator's order. Velocities are extra fields to the
Domain: every sync carries them by `reapply_sync`, as the reference's
clients move the per-particle quantities that take no part in halo
discovery. Over several ranks the energy, momentum and overflow are
reduced by the Domain's comm (the JAX package's psum / pmax over its
axis_name).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from ..domain.domain import Domain, DomainState, SyncResult
from ..traversal.neighbors import _find_neighbors_impl

__all__ = ["SimState", "sim_init", "sim_step", "sim_diagnostics"]


@dataclass(frozen=True)
class SimState:
    domain: DomainState
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    h: torch.Tensor
    vx: torch.Tensor
    vy: torch.Tensor
    vz: torch.Tensor
    n_local: torch.Tensor


def sim_init(dstate: DomainState, x, y, z, h, vx, vy, vz, n_local) -> SimState:
    """The loop's state; n_local (int or 0-d tensor) becomes a 0-d int64
    tensor on the particles' device."""
    return SimState(domain=dstate, x=x, y=y, z=z, h=h, vx=vx, vy=vy, vz=vz,
                    n_local=torch.as_tensor(n_local, dtype=torch.int64, device=x.device))


def _pair_terms(res: SyncResult, box, k_spring, ng_max, group_size, cand_leaf_cap, cand_cap, chunk,
                domain: Domain):
    """Per-particle force and potential from the Hookean contact force,
    and the neighbour pass's overflow flag (0-d int64)."""
    view = domain.ns_view(res, box)
    cap = res.x.shape[0]
    frontier_cap = 64
    # the targets are the owned slots (two host reads), whose forces the
    # step uses; every slot is a candidate. The JAX package targets all
    # `cap` slots: its groups then also run over the halo slots, where
    # consecutive particles may lie in distant halo leaves, and over the
    # empty slots' zeros, and at scale such a group's candidates overflow
    # every capacity
    start, end = int(res.start_index), min(int(res.end_index), cap)
    counts, nbs, stats = _find_neighbors_impl(
        res.x, res.y, res.z, res.h, view, box, ng_max=ng_max, group_size=group_size,
        cand_leaf_cap=cand_leaf_cap, cand_cap=cand_cap, chunk=chunk, with_indices=True,
        n_targets=end - start, frontier_cap=frontier_cap, target_offset=start)
    in_buf = torch.arange(cap, device=res.x.device) < res.n_with_halos
    # the JAX package does not check the traversal frontier, whose
    # overflow drops candidate leaves; the port counts it as an overflow
    ns_overflow = ((stats.cand_max > cand_cap) | (stats.leaf_max > cand_leaf_cap)
                   | (stats.frontier_max > frontier_cap)
                   | (torch.where(in_buf, counts, 0).max() > ng_max)).to(torch.int64)

    nb_valid = nbs >= 0
    nb = torch.clamp(nbs, min=0)
    d = [c[:, None] - c[nb] for c in (res.x, res.y, res.z)]
    if any(box.periodic_mask):
        lengths = box.lengths.to(res.x.dtype)
        pm = torch.as_tensor(box.periodic_mask, dtype=res.x.dtype, device=res.x.device)
        d = [dc - pm[a] * lengths[a] * torch.round(dc * (1.0 / lengths)[a]) for a, dc in enumerate(d)]
    r = torch.sqrt(torch.clamp(d[0] * d[0] + d[1] * d[1] + d[2] * d[2], min=1e-20))
    reach = 2.0 * res.h[:, None]
    overlap = torch.where(nb_valid & (r < reach), reach - r, 0.0)
    # F = k overlap r_hat (repulsive), U = k/2 overlap^2
    coef = k_spring * overlap / r
    fx, fy, fz = ((coef * dc).sum(dim=-1) for dc in d)
    pot = 0.5 * k_spring * (overlap * overlap).sum(dim=-1)  # counts each pair twice
    return fx, fy, fz, pot, ns_overflow


def sim_step(
    domain: Domain,
    state: SimState,
    dt: float,
    k_spring: float = 50.0,
    ng_max: int = 96,
    group_size: int = 32,
    cand_leaf_cap: int = 256,
    cand_cap: int = 4096,
    chunk: int = 16,
) -> Tuple[SimState, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One kick-drift-kick step. Returns (state', energy, momentum (3,),
    overflow). Energy and momentum are summed over the owned particles
    and over the ranks; conserved up to the integrator's O(dt^2) error.
    The overflow is the largest of the sync's and the neighbour pass's,
    over all ranks."""
    dstate, res = domain.sync(state.domain, state.x, state.y, state.z, state.h, n_local=state.n_local)
    box = dstate.box
    cap = res.x.shape[0]
    j = torch.arange(cap, device=res.x.device)
    owned = (j >= res.start_index) & (j < res.end_index)

    # velocities are extra fields: replay the sync's exchange for them
    vx, vy, vz = (domain.reapply_sync(res, v) for v in (state.vx, state.vy, state.vz))
    fx, fy, fz, pot, ovf = _pair_terms(res, box, k_spring, ng_max, group_size, cand_leaf_cap, cand_cap,
                                       chunk, domain)

    half = 0.5 * dt
    vx1, vy1, vz1 = vx + half * fx, vy + half * fy, vz + half * fz
    new = [c + dt * v for c, v in ((res.x, vx1), (res.y, vy1), (res.z, vz1))]
    # wrap periodic dims back into the box
    lengths = box.lengths.to(res.x.dtype)
    mins = box.mins.to(res.x.dtype)
    new = [mins[a] + torch.remainder(c - mins[a], lengths[a]) if box.periodic_mask[a] else c
           for a, c in enumerate(new)]

    # the second kick reuses the pre-drift forces: at test-scale dt the
    # neighbour topology barely changes within a step, and the next
    # step's sync recomputes them
    vx2, vy2, vz2 = vx1 + half * fx, vy1 + half * fy, vz1 + half * fz

    # energy sampled at the step's start (velocities before the kick,
    # potential at the synced positions), so every step measures the same
    # invariant
    ke = 0.5 * torch.where(owned, vx * vx + vy * vy + vz * vz, 0.0).sum()
    pe = 0.5 * torch.where(owned, pot, 0.0).sum()  # each pair counted twice
    energy = ke + pe
    momentum = torch.stack([torch.where(owned, v, 0.0).sum() for v in (vx2, vy2, vz2)])
    if domain.comm is not None:
        energy = domain.comm.all_reduce(energy, "sum")
        momentum = domain.comm.all_reduce(momentum, "sum")
        ovf = domain.comm.all_reduce(ovf, "max")
    ovf = torch.maximum(ovf, res.overflow)

    co = domain.compact_owned
    new_state = SimState(
        domain=dstate, x=co(res, new[0]), y=co(res, new[1]), z=co(res, new[2]), h=co(res, res.h),
        vx=co(res, vx2), vy=co(res, vy2), vz=co(res, vz2), n_local=res.end_index - res.start_index)
    return new_state, energy, momentum, ovf


def sim_diagnostics(state: SimState) -> dict:
    """Owned particle count and rms speed, on the host."""
    n = int(state.n_local)
    v2 = state.vx[:n] ** 2 + state.vy[:n] ** 2 + state.vz[:n] ** 2
    return {"n_local": n, "v_rms": float(torch.sqrt(v2.mean()))}
