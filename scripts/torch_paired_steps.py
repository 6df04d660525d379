"""Step medians of three main paths of the PyTorch/CUDA port and the times
of the B4 and B6 kernels on their arguments, for one checkout, so that two
trees can be compared in turns on one card (parent, change, change,
parent).

    python3 scripts/torch_paired_steps.py [--root DIR] [--label NAME]
        [--steps 10] [--reps 20] [--device cuda] [--n N]

--root is the checkout whose cstone_tpu_torch and chip_smoke.py helpers
are imported (default: this one). On 1M particles, the configurations of
chip_smoke.py:

- phase 4: uniform in the periodic unit box, h = 0.012, bucket 64;
  Domain.sync + cell_list_neighbor_counts at level 5, cap 64, --steps
  drift steps; then B4 (stencil_counts_asym, the impl="pallas_asym"
  route) timed on the last step's ELL planes;
- path A (phase 5): Gaussian, adaptive h; Domain.sync +
  cell_list_neighbor_counts_tiered, --steps drift steps;
- path B (phase 6): phase 4's particles; Domain.sync + ns_view +
  find_neighbors "v2", --steps drift steps; then one "v1" pass, whose B6
  launch (pairwise_count) is timed on its own arguments and checked
  bit-equal to its plain version.

Each step is timed by CUDA events around it (host clock on the CPU);
kernels by CUDA events around --reps back-to-back launches after a
warm-up. B4's counts are checked equal to impl="xla" on the same planes.
The last line of the output is one JSON object with every number. On the
CPU (--device cpu, a small --n; h and the cell level scale with n) the
kernels are the plain versions and the numbers are the host's.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--label", default="")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=1_000_000)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch

    import chip_smoke as cs
    from cstone_tpu_torch.domain import Domain, sync_with_retry
    from cstone_tpu_torch.ops import neighbors_v1, stencil
    from cstone_tpu_torch.ops.cuda_lib import record_launches
    from cstone_tpu_torch.sfc import PERIODIC, make_box
    from cstone_tpu_torch.traversal import (
        cell_list_neighbor_counts,
        cell_list_neighbor_counts_tiered,
        choose_cell_level,
        choose_tier_levels,
        find_neighbors,
        tier_caps,
    )
    from cstone_tpu_torch.utils.workloads import adaptive_h, gaussian_coords

    dev = torch.device(args.device)
    on_card = dev.type == "cuda"
    cs.N, cs.H = args.n, cs.H * (1e6 / args.n) ** (1.0 / 3.0)
    n = cs.N
    card = cs.card_line() if on_card else "cpu"
    if not on_card:  # a small n's groups reach more leaves and runs (the CPU rehearsal's settings)
        cs.NB_KW = dict(group_size=256, cand_leaf_cap=640, cand_cap=16384, run_cap=96, frontier_cap=256)
    t0 = time.perf_counter()
    if on_card:
        cs.build_all()
    build_s = time.perf_counter() - t0
    box = make_box(0.0, 1.0, boundaries=PERIODIC, device=dev)
    level = choose_cell_level(box, cs.H)

    def timed(fn):
        if not on_card:
            t = time.perf_counter()
            out = fn()
            return out, 1e3 * (time.perf_counter() - t)
        return cs.timed_ms(fn)

    def kernel_ms(fn):
        if not on_card:
            return timed(fn)[1]
        return cs.cuda_time_ms(fn, args.reps)

    def cold(xyz, h):
        """A Domain and its state after one cold sync of xyz (the tree's
        capacity grown by sync_with_retry)."""
        def attempt(caps):
            domain = Domain(bucket_size=cs.BUCKET, tree_capacity=caps["tree"], device=dev)
            state, res = domain.sync(domain.init_state(box=box, boundaries=(1, 1, 1)), *xyz, h)
            return domain, state, res

        (domain, state, _), _ = sync_with_retry(attempt, {"tree": cs.tree_capacity(n)})
        return domain, state

    def run_steps(xyz, drift, h, after_sync):
        """A cold sync, then --steps drift steps of sync + after_sync;
        returns (step ms, the last step's (state, res, after_sync's
        result))."""
        domain, state = cold(xyz, h)
        ms, sgn, last = [], 1.0, None
        for _ in range(args.steps):
            xyz = cs.drifted(xyz, drift, sgn)

            def step():
                st, res = domain.sync(state, *xyz, h)
                return st, res, after_sync(domain, st, res)

            (state, res, extra), t = timed(step)
            if int(res.overflow) != 0:
                raise RuntimeError(f"overflow {res.overflow_detail.tolist()}")
            ms.append(t)
            last = (state, res, extra)
            sgn = -sgn
        return ms, last

    out = {"label": args.label, "root": root, "card": card, "n": n, "level": level,
           "steps": args.steps, "build_s": build_s}

    # phase 4: sync + cell-list counts, then B4 on the last step's planes
    xyz, drift, h = cs.uniform_setup(dev)
    cap = cs.CAP

    def counts(domain, st, res):
        c, ovf = cell_list_neighbor_counts(res.keys, res.x, res.y, res.z, res.h, st.box, level, cap,
                                           n_valid=res.end_index, const_h=True)
        if bool(ovf):
            raise RuntimeError("cell-list cap overflowed")
        return c

    ms, (state, res, _) = run_steps(xyz, drift, h, counts)
    out["phase4_step_ms"] = ms
    px, py, pz, _, r2, _, valid = cs.ell_inputs(res.keys, res.x, res.y, res.z, res.h, state.box,
                                                level, cap, n_valid=res.end_index)
    b4_args = (px, py, pz, r2, valid, state.box.lengths, (True,) * 3, level)
    if not torch.equal(stencil.stencil_counts_asym(*b4_args), stencil.stencil_counts_plain(*b4_args)):
        raise RuntimeError("B4 differs from impl=\"xla\"")
    out["b4_ms"] = kernel_ms(lambda: stencil.stencil_counts_asym(*b4_args))
    del px, py, pz, r2, valid, b4_args, res, state

    # path A: sync + tiered counts
    pos = gaussian_coords(n, (0.0, 1.0) * 3, seed=cs.SEED)
    h_np = adaptive_h(pos, (0.0, 1.0) * 3, 100.0)
    levels = choose_tier_levels(h_np, 1.0, max_tiers=3)
    caps, cross = tier_caps(pos, h_np, (0.0, 1.0), levels, slack=1.3)
    rng = np.random.RandomState(cs.SEED)
    drift_a = torch.from_numpy(rng.uniform(-0.2, 0.2, size=(n, 3)).astype(np.float32)
                               * (1.0 / n) ** (1.0 / 3.0)).to(dev)
    xyz_a = tuple(torch.from_numpy(np.ascontiguousarray(pos[:, i])).to(dev) for i in range(3))

    def tiered(domain, st, res):
        c, ovf = cell_list_neighbor_counts_tiered(res.keys, res.x, res.y, res.z, res.h, st.box,
                                                  levels, caps, cross, n_valid=res.end_index)
        if bool(ovf):
            raise RuntimeError("tiered counts overflowed")
        return c

    out["path_a_step_ms"], _ = run_steps(xyz_a, drift_a, torch.from_numpy(h_np).to(dev), tiered)
    out["path_a_levels"] = list(levels)

    # path B: sync + ns_view + find_neighbors v2, then one v1 pass (B6)
    def find(domain, st, res):
        view = domain.ns_view(res, st.box)
        c, _ = find_neighbors(res.x, res.y, res.z, res.h, view, st.box, use_pallas="v2",
                              n_targets=n, **cs.NB_KW)
        return view

    ms, (state, res, view) = run_steps(xyz, drift, h, find)
    out["path_b_step_ms"] = ms
    with record_launches() as calls:
        find_neighbors(res.x, res.y, res.z, res.h, view, state.box, use_pallas="v1", n_targets=n,
                       **cs.NB_KW)
    if on_card:
        [(name, b6_args, got)] = calls
        if name != "pairwise_count" or not torch.equal(got, neighbors_v1.pairwise_count_plain(*b6_args)):
            raise RuntimeError("B6 differs from its plain version")
        out["b6_ms"] = kernel_ms(lambda: neighbors_v1.pairwise_count(*b6_args))
        out["b6_shape"] = list(b6_args[0].shape[:2]) + [b6_args[2].shape[1]]

    for k in ("phase4", "path_a", "path_b"):
        out[f"{k}_median_ms"] = float(np.median(out[f"{k}_step_ms"]))
    print(f"{args.label}: phase 4 {out['phase4_median_ms']:.3f}, path A {out['path_a_median_ms']:.3f}, "
          f"path B {out['path_b_median_ms']:.3f} ms a step (medians); B4 {out['b4_ms']:.4f} ms, B6 "
          f"{out.get('b6_ms', float('nan')):.4f} ms [{card}]", flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
