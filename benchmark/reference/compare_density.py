"""The comparison that decides `correct` in the cells of the SPH density
(traffic `density`): one step's outputs of the program against the plain
reference of the same step.

The program's outputs are those of compare.py's cells with the density
in place of the neighbour count: per buffer slot the particle id, the
SFC key, the position and the density, the owned range and the global
octree. The reference works the step out again from the sample the
harness made from the seed: the positions by id after that many drift
steps, their keys, the cornerstone tree, and the densities of
density.py with the masses by id.

Each number counts faults, limit 0 (compare.py's six, with the density
in place of the count):

  position_mismatch, key_mismatch, order_faults, owner_faults,
  tree_mismatch, failed_steps   as compare.py counts them
  density_mismatch              owned particles whose density lies
                                outside the bound below of the
                                reference's (or whose id is no id)

The bound. The program's terms m_j W(q_ij) are the reference's bit for
bit (the same float32 operations in the same order, ops/stencil.py's
contract), but they are summed in another order: the kernel adds them
with float atomics in an order that varies from run to run. Each of the
two sums of k_i positive terms (k_i the reference's neighbours with
q < 2) lies within (k_i - 1) u of the exact sum, relatively, u = 2^-24
(Higham, Accuracy and Stability of Numerical Algorithms, 4.2, for any
order of pairwise additions). Then both add m_i (one rounding each) and
multiply by 1/h_i three times and by 1/pi (four roundings each). So

  |rho - rho_ref| <= (2 (k_i - 1) + 2 + 8 + 4) u rho_ref
                   = 2 (k_i + 6) u rho_ref

the last 4 u a margin for the second-order terms (k_i^2 u^2 < 1e-10
at ~116 neighbours). At the cell's 116 neighbours that is 1.5e-5 of the
density; a float32 sum in any order meets it, while the same sums in
bfloat16, without the self term, or with m_i in place of m_j miss it by
orders of magnitude (the control and the tests)."""

from __future__ import annotations

import torch

from .compare import tree_mismatch

U = 2.0 ** -24  # float32's unit roundoff

LIMITS = {"position_mismatch": 0, "key_mismatch": 0, "order_faults": 0, "owner_faults": 0,
          "tree_mismatch": 0, "density_mismatch": 0, "failed_steps": 0}


def density_bound(rho_ref: torch.Tensor, near: torch.Tensor) -> torch.Tensor:
    """The largest distance from the reference's density that a float32
    sum of the same terms in another order may lie: 2 (k_i + 6) u rho."""
    return 2.0 * (near.double() + 6.0) * U * rho_ref.double().abs()


def density_faults(rho: torch.Tensor, rho_ref: torch.Tensor, near: torch.Tensor) -> torch.Tensor:
    """Per particle: the density lies outside the bound (or is not finite)."""
    gap = (rho.double() - rho_ref.double()).abs()
    return ~(gap <= density_bound(rho_ref, near))


def step_numbers(out: dict, ref: dict, comm=None) -> dict:
    """The fault counts of one checked step, summed over the ranks (the
    tree, the same on every rank, is counted once). `ref` holds xyz,
    keys, tree, rho and near by id."""
    n = ref["keys"].numel()
    s, e = int(out["start"]), int(out["end"])
    ids = out["ids"][s:e].long()
    known = (ids >= 0) & (ids < n)
    idc = ids.clamp(0, n - 1)
    pos_bad = ~known
    for c, rc in zip(out["xyz"], ref["xyz"]):
        pos_bad |= c[s:e] != rc[idc]
    keys = out["keys"][s:e]
    local = torch.stack([
        pos_bad.sum(),
        ((keys != ref["keys"][idc]) | ~known).sum(),
        (keys[1:] < keys[:-1]).sum(),
        (density_faults(out["rho"][s:e], ref["rho"][idc], ref["near"][idc]) | ~known).sum(),
    ])
    owners = torch.zeros(n, dtype=torch.int64, device=ids.device).index_add_(
        0, idc[known], torch.ones_like(idc[known]))
    tk, tc, nn = out["tree"]
    tm = torch.tensor(tree_mismatch(tk[:nn + 1], tc[:nn], *ref["tree"]), device=ids.device)
    if comm is not None:
        local = comm.all_reduce(local, "sum")
        owners = comm.all_reduce(owners, "sum")
        tm = comm.all_reduce(tm, "max")
    pos, key, order, density = (int(v) for v in local.tolist())
    return {"position_mismatch": pos, "key_mismatch": key, "order_faults": order,
            "owner_faults": int((owners != 1).sum()), "tree_mismatch": int(tm), "density_mismatch": density}
