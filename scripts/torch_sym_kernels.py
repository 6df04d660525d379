"""Times of the symmetric stencil kernels of the PyTorch/CUDA port (B1, B2
and B3, csrc/stencil_sym.cu) on the arguments of its main paths.

    python3 scripts/torch_sym_kernels.py [--root DIR] [--label NAME] [--reps 20]

--root is the checkout whose cstone_tpu_torch and chip_smoke.py helpers are
imported (default: this one), so that two trees can be timed by this one
script on one card, in turns. Two sets of arguments:

- the phase-4 shape of chip_smoke.py: 1M uniform particles after one
  Domain.sync, cell level 5, cap 64; B1 counts and B2 density with masses;
- path A (chip_smoke.py phase 5): one tiered count on 1M Gaussian
  particles with adaptive h after one Domain.sync; every B1 and B3 launch
  it makes is recorded and timed again on its own arguments. For each B3
  pass the script also prints each table's busy 32-slot chunks and valid
  slots (what the kernel chooses its lane table from) and the warps a
  grid of every (cell, chunk) of that table would hold.

Each launch is timed two ways, as the mean of --reps launches after one
warm-up: "ms" between CUDA events around the wrapper calls (what a caller
waits for: the host's issue time when that is the longer), and under
torch.profiler "device_ms", the device time of every kernel and memset
the calls ran (output zeroing and prologues included), and "kernel_ms",
that of the stencil kernel alone, and "queued_ms", chip_smoke.py's
device_time_ms: CUDA events around the calls queued behind a spin kernel,
so the host's issue time is hidden. Each timed launch's counts are checked
equal to the path's own. The last line of the output is one JSON object
with every number.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def table_stats(valid):
    """(busy 32-slot chunks, valid slots, warps of a full (cell, chunk) grid)."""
    n = valid.sum(dim=1)
    return (int(((n + 31) // 32).sum()), int(n.sum()),
            valid.shape[0] * -(-valid.shape[1] // 32))


def device_ms(fn, reps):
    """(device ms of all kernels and memsets, of the stencil kernel alone)
    per call, over reps calls under torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = [(e.name, e.time_range.end - e.time_range.start) for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    main = sum(us for name, us in spans if "sym_kernel" in name or "stencil_kernel" in name)
    return sum(us for _, us in spans) / 1e3 / reps, main / 1e3 / reps


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--label", default="")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch

    import chip_smoke as cs
    from cstone_tpu_torch.domain import Domain, sync_with_retry
    from cstone_tpu_torch.ops import stencil
    from cstone_tpu_torch.ops.cuda_lib import record_launches
    from cstone_tpu_torch.sfc import PERIODIC, make_box
    from cstone_tpu_torch.traversal import cell_list_neighbor_counts_tiered, choose_tier_levels, tier_caps
    from cstone_tpu_torch.utils.workloads import adaptive_h, gaussian_coords

    dev = torch.device("cuda")
    card = cs.card_line()
    stencil.load_library()
    box = make_box(0.0, 1.0, boundaries=PERIODIC, device=dev)

    def synced(xyz, h):
        def warm(caps):
            domain = Domain(bucket_size=cs.BUCKET, tree_capacity=caps["tree"], device=dev)
            return domain.sync(domain.init_state(box=box, boundaries=(1, 1, 1)), *xyz, h)

        return sync_with_retry(warm, {"tree": cs.tree_capacity(cs.N)})[0]

    # the phase-4 shape
    xyz, _, h = cs.uniform_setup(dev)
    state, res = synced(xyz, h)
    mass = torch.full((cs.N,), 1.0 / cs.N, dtype=torch.float32, device=dev)
    px, py, pz, ph, r2, pm, valid = cs.ell_inputs(res.keys, res.x, res.y, res.z, res.h, state.box,
                                                  cs.LEVEL, cs.CAP, mass=mass, n_valid=res.end_index)
    flags, L = (True,) * 3, state.box.lengths
    counts_args = (px, py, pz, r2, valid, L, flags, cs.LEVEL)
    calls = [("stencil_counts", counts_args, stencil.stencil_counts(*counts_args)),
             ("stencil_density", (px, py, pz, ph, valid, L, flags, cs.LEVEL, pm), None)]
    where = ["phase 4", "phase 4"]

    # path A
    pos = gaussian_coords(cs.N, (0.0, 1.0) * 3, seed=cs.SEED)
    h_np = adaptive_h(pos, (0.0, 1.0) * 3, 100.0)
    levels = choose_tier_levels(h_np, 1.0, max_tiers=3)
    caps, cross = tier_caps(pos, h_np, (0.0, 1.0), levels, slack=1.3)
    xyz = tuple(torch.from_numpy(pos[:, i].copy()).to(dev) for i in range(3))
    state, res = synced(xyz, torch.from_numpy(h_np).to(dev))
    with record_launches() as path_a:
        _, ovf = cell_list_neighbor_counts_tiered(res.keys, res.x, res.y, res.z, res.h, state.box,
                                                  levels, caps, cross, n_valid=res.end_index)
    if bool(ovf):
        raise RuntimeError("path A overflowed")
    calls += path_a
    where += ["path A"] * len(path_a)

    rows = []
    for (name, call_args, got), at in zip(calls, where):
        fn = lambda: getattr(stencil, name)(*call_args)
        if got is not None:
            again = fn()
            same = all(torch.equal(a, b) for a, b in zip(again, got)) if name == "stencil_cross" \
                else torch.equal(again, got)
            if not same:
                raise RuntimeError(f"{name} ({at}) gave other counts on a second launch")
        row = {"name": name, "at": at, "ms": cs.cuda_time_ms(fn, args.reps)}
        row["device_ms"], row["kernel_ms"] = device_ms(fn, args.reps)
        row["queued_ms"] = cs.device_time_ms(fn, args.reps)
        if name == "stencil_cross":
            ta, tb, level = call_args[0], call_args[1], call_args[4]
            row.update(level=level, caps=[ta[0].shape[1], tb[0].shape[1]],
                       a=dict(zip(("chunks", "slots", "grid_warps"), table_stats(ta[4]))),
                       b=dict(zip(("chunks", "slots", "grid_warps"), table_stats(tb[4]))))
        else:
            row.update(level=call_args[7], caps=[call_args[0].shape[1]],
                       a=dict(zip(("chunks", "slots", "grid_warps"), table_stats(call_args[4]))))
        rows.append(row)
        print(f"{args.label}: {json.dumps(row)} [{card}]", flush=True)
    print(json.dumps({"label": args.label, "root": root, "card": card, "levels": list(levels),
                      "cross_caps": {str(k): v for k, v in cross.items()}, "launches": rows}),
          flush=True)


if __name__ == "__main__":
    main()
