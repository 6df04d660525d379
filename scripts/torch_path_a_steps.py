"""Step times and a one-step profile of path A of the PyTorch/CUDA port:
Domain.sync + cell_list_neighbor_counts_tiered on 1M Gaussian particles
with adaptive h, the configuration of chip_smoke.py phase 5.

    python3 scripts/torch_path_a_steps.py [--root DIR] [--label NAME]
        [--steps 30] [--n 1000000] [--device cuda] [--out FILE]

--root is the checkout whose cstone_tpu_torch is imported (default: this
one), so that two trees can be timed by this one script on one card, in
turns. Each drift step is timed with CUDA events at its start, after the
sync and after the tiered counts (the step is host-bound, so these follow
the host's progress). One more step runs under torch.profiler: its kernel
count, the kernel time summed, the union of the kernel intervals and the
device's idle share of the profiled step. The last line of the output is
one JSON object with all of it; --out also receives the profiler's tables
by self CPU time and by device time. On the CPU (--device cpu, a small
--n) the step times come from the host clock and no profile is taken.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

SEED = 42
BUCKET = 64


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--label", default="")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import torch

    from cstone_tpu_torch.domain import Domain, sync_with_retry
    from cstone_tpu_torch.sfc import PERIODIC, make_box
    from cstone_tpu_torch.traversal import cell_list_neighbor_counts_tiered, choose_tier_levels, tier_caps
    from cstone_tpu_torch.utils.workloads import adaptive_h, gaussian_coords

    dev = torch.device(args.device)
    on_card = dev.type == "cuda"
    n = args.n
    pos = gaussian_coords(n, (0.0, 1.0) * 3, seed=SEED)
    h_np = adaptive_h(pos, (0.0, 1.0) * 3, 100.0)
    levels = choose_tier_levels(h_np, 1.0, max_tiers=3)
    caps, cross = tier_caps(pos, h_np, (0.0, 1.0), levels, slack=1.3)
    rng = np.random.RandomState(SEED)
    drift = torch.from_numpy(rng.uniform(-0.2, 0.2, size=(n, 3)).astype(np.float32)
                             * (1.0 / n) ** (1.0 / 3.0)).to(dev)
    xyz = tuple(torch.from_numpy(np.ascontiguousarray(pos[:, i])).to(dev) for i in range(3))
    h = torch.from_numpy(h_np).to(dev)
    box = make_box(0.0, 1.0, boundaries=PERIODIC, device=dev)
    tree_capacity = max(4096, int(3.2 * n / BUCKET) // 1024 * 1024 + 4096)

    def sync(domain, state, x, y, z):
        return domain.sync(state, x, y, z, h)

    def counts(state, res):
        c, ovf = cell_list_neighbor_counts_tiered(
            res.keys, res.x, res.y, res.z, res.h, state.box, levels, caps, cross,
            n_valid=res.end_index)
        return c, torch.maximum(res.overflow, ovf.long())

    def warm(caps_):
        domain = Domain(bucket_size=BUCKET, tree_capacity=caps_["tree"], device=dev)
        state, res = sync(domain, domain.init_state(box=box, boundaries=(1, 1, 1)), *xyz)
        c, ovf = counts(state, res)
        return domain, state, c, dataclasses.replace(res, overflow=ovf)

    (domain, state, c, res), _ = sync_with_retry(warm, {"tree": tree_capacity})

    def marks():
        if on_card:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def span_ms(a, b):
        if on_card:
            b.synchronize()
            return a.elapsed_time(b)
        return 1e3 * (b - a)

    def step(sgn):
        nonlocal xyz, state
        xyz = tuple((v + sgn * drift[:, i]) % 1.0 for i, v in enumerate(xyz))
        t0 = marks()
        state, res = sync(domain, state, *xyz)
        t1 = marks()
        c, ovf = counts(state, res)
        t2 = marks()
        if int(ovf) != 0:
            raise RuntimeError(f"path A overflowed: {res.overflow_detail.tolist()}")
        return span_ms(t0, t1), span_ms(t1, t2), c

    rows, sgn = [], 1.0
    for _ in range(args.steps):
        rows.append(step(sgn)[:2])
        sgn = -sgn
    sync_ms, counts_ms = [r[0] for r in rows], [r[1] for r in rows]
    step_ms = [a + b for a, b in rows]
    out = {"label": args.label, "levels": list(levels), "caps": list(caps), "n": n,
           "steps": args.steps, "step_ms": step_ms, "sync_ms": sync_ms, "counts_ms": counts_ms,
           "median_step_ms": float(np.median(step_ms)), "median_sync_ms": float(np.median(sync_ms)),
           "median_counts_ms": float(np.median(counts_ms))}

    if on_card:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            sync_p, counts_p, _ = step(sgn)
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
        events = prof.events()
        kern = sorted((e.time_range.start, e.time_range.end) for e in events
                      if e.device_type == DeviceType.CUDA)
        busy, end = 0.0, -1.0
        for s, e in kern:  # union of the kernel intervals, us
            if e > end:
                busy += e - max(s, end)
                end = e
        n_ops = sum(1 for e in events if e.device_type == DeviceType.CPU and e.name.startswith("aten::"))
        out["profile"] = {
            "step_ms_events": sync_p + counts_p, "step_ms_wall": wall, "device_ops": len(kern),
            "kernel_ms_sum": sum(e - s for s, e in kern) / 1e3, "kernel_ms_union": busy / 1e3,
            "idle_share": 1.0 - busy / 1e3 / wall, "aten_ops": n_ops}
        if args.out:
            ka = prof.key_averages()
            dev_key = ("self_device_time_total" if hasattr(ka[0], "self_device_time_total")
                       else "self_cuda_time_total")
            with open(args.out, "w") as f:
                f.write(f"{args.label}: {json.dumps(out['profile'])}\n\n")
                f.write(ka.table(sort_by="self_cpu_time_total", row_limit=30) + "\n\n")
                f.write(ka.table(sort_by=dev_key, row_limit=30) + "\n")
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
