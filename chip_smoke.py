#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (cstone_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure raises and exits non-zero:
  1. card: nvidia-smi name and power limit, torch's device name; refuses
     to run without CUDA (there is no CPU fallback);
  2. build: compiles the stencil kernel from csrc/stencil.cu with nvcc;
  3. kernel vs plain version on the card: level 3 and 5 grids, cap 64,
     periodic and open boxes, uniform and Gaussian particles, per-particle
     radii; counts bit-equal, density within rtol 1e-5;
  4. main path at full size: 1M uniform particles in the periodic unit
     box, h = 0.012, bucket 64, cell level 5, ELL cap 64. Domain.sync +
     cell_list_neighbor_counts for 1 warm and 10 drift steps, then 3
     steps of the SPH density cell path. Checks overflow, mean neighbour
     count 57.9 +- 0.5, mean density within 2% of 1 + 1/(pi h^3 n), the
     cornerstone invariants, and that every kernel launched; times each
     step and the kernels against their plain versions at this shape.
The line before last is the kernel summary JSON; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time

import numpy as np

N = 1_000_000
SEED = 42
H = 0.012
BUCKET = 64
LEVEL = 5
CAP = 64
DRIFT_STEPS = 10
SPH_STEPS = 3
KERNEL_SOURCE = "cstone_tpu_torch/csrc/stencil.cu"
REPLACES = "cstone_tpu/ops/pallas_stencil.py:295"  # _kernel_sym


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def phase(name):
    print(f"== {name}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps):
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def ell_inputs(keys, xs, ys, zs, hs, box, level, cap, mass=None, n_valid=None):
    """ELL planes as the main path hands them to the kernels."""
    import torch

    from cstone_tpu_torch.traversal import celllist

    perm, _ = celllist.rowmajor_cell_perm(level, device=xs.device)
    fields = (xs, ys, zs, hs) + (() if mass is None else (mass,))
    packed, valid, _, ovf = celllist.ell_pack(keys, perm, fields, cap, level, n_valid=n_valid)
    check(not bool(ovf), f"ELL cap {cap} overflowed at level {level}")
    px, py, pz, ph = packed[:4]
    r2 = torch.where(valid, (2.0 * ph) * (2.0 * ph), -1.0)
    pm = torch.where(valid, packed[4], 0.0) if mass is not None else None
    return px, py, pz, ph, r2, pm, valid


def compare_kernels(planes, box, level):
    """Kernel vs plain on one set of ELL planes: (count max |diff|,
    density max |diff| over unit and per-particle mass)."""
    import torch

    from cstone_tpu_torch.ops import stencil

    px, py, pz, ph, r2, pm, valid = planes
    flags = tuple(b == 1 for b in box.boundaries)
    got = stencil.stencil_counts(px, py, pz, r2, valid, box.lengths, flags, level)
    want = stencil.stencil_counts_plain(px, py, pz, r2, valid, box.lengths, flags, level)
    check(torch.equal(got, want), f"counts differ from the plain version (level {level}, {flags})")
    count_err = int((got - want).abs().max())
    dens_err = 0.0
    for mass in (None, pm):
        got = stencil.stencil_density(px, py, pz, ph, valid, box.lengths, flags, level, mass)
        want = stencil.stencil_density_plain(px, py, pz, ph, valid, box.lengths, flags, level, mass)
        ok = torch.allclose(got, want, rtol=1e-5, atol=1e-6)
        check(ok, f"density differs from the plain version beyond rtol 1e-5 (level {level})")
        dens_err = max(dens_err, float((got - want).abs().max()))
    return count_err, dens_err


def kernel_vs_plain_phase(dev):
    """Phase 3: small grids, both boundaries, uniform and clustered."""
    import torch

    from cstone_tpu_torch.ops.keys64 import usort
    from cstone_tpu_torch.sfc import compute_sfc_keys, make_box
    from cstone_tpu_torch.utils.workloads import gaussian_coords

    for level, n in ((3, 2500), (5, 150_000)):  # fullest cell stays below cap 64
        for periodic in (True, False):
            for dist in ("uniform", "gauss"):
                rng = np.random.RandomState(7)
                if dist == "gauss":
                    pos = gaussian_coords(n, (0.0, 1.0) * 3, seed=7)
                else:
                    pos = rng.uniform(0.0, 1.0, size=(n, 3)).astype(np.float32)
                h = rng.uniform(0.3, 0.5, size=n).astype(np.float32) / (1 << level)
                m = rng.uniform(0.5, 1.5, size=n).astype(np.float32)
                box = make_box(0.0, 1.0, boundaries=int(periodic), device=dev)
                p = torch.from_numpy(pos).to(dev)
                keys, order = usort(compute_sfc_keys(p[:, 0], p[:, 1], p[:, 2], box, np.uint64))
                cols = [c[order].contiguous() for c in (p[:, 0], p[:, 1], p[:, 2])]
                ht = torch.from_numpy(h).to(dev)[order]
                mt = torch.from_numpy(m).to(dev)[order]
                planes = ell_inputs(keys, *cols, ht, box, level, CAP, mass=mt)
                cerr, derr = compare_kernels(planes, box, level)
                print(f"kernel vs plain: level {level} n {n} periodic {periodic} {dist}: "
                      f"counts max|diff| {cerr}, density max|diff| {derr:.3e}", flush=True)
    torch.cuda.synchronize()


def cornerstone_ok(tree, n) -> None:
    from cstone_tpu_torch.ops.keys64 import to_numpy

    nn = int(tree.n_nodes)
    keys = to_numpy(tree.keys)[: nn + 1]
    check(keys[0] == 0 and int(keys[-1]) == 1 << 63, "cornerstone tree must span [0, 2^63)")
    d = np.diff(keys)
    check(bool(((d & (d - np.uint64(1))) == 0).all() and (d > 0).all()), "leaf ranges are powers of 2")
    lz = np.array([int(v).bit_length() - 1 for v in d])
    check(bool((lz % 3 == 0).all()), "leaf ranges are powers of 8")
    check(int(tree.counts[:nn].sum()) == n, "leaf counts sum to n")


def main_path_phase(dev, card):
    """Phase 4: the port's timestep at full size through its public API."""
    import torch

    from cstone_tpu_torch.domain import Domain, sync_with_retry
    from cstone_tpu_torch.models import SphState, sph_density_step
    from cstone_tpu_torch.ops import stencil
    from cstone_tpu_torch.sfc import PERIODIC, make_box
    from cstone_tpu_torch.traversal import cell_list_neighbor_counts, choose_cell_level

    rng = np.random.RandomState(SEED)
    pos = rng.uniform(0.0, 1.0, size=(N, 3)).astype(np.float32)
    spacing = (1.0 / N) ** (1.0 / 3.0)
    drift = torch.from_numpy(rng.uniform(-0.2, 0.2, size=(N, 3)).astype(np.float32) * spacing).to(dev)
    x, y, z = (torch.from_numpy(np.ascontiguousarray(pos[:, i])).to(dev) for i in range(3))
    h = torch.full((N,), H, dtype=torch.float32, device=dev)
    box = make_box(0.0, 1.0, boundaries=PERIODIC, device=dev)
    level = choose_cell_level(box, H)
    check(level == LEVEL, f"cell level {level} != {LEVEL}")
    tree_capacity = max(4096, int(3.2 * N / BUCKET) // 1024 * 1024 + 4096)

    def step(domain, state, x, y, z):
        state, res = domain.sync(state, x, y, z, h)
        counts, cell_ovf = cell_list_neighbor_counts(
            res.keys, res.x, res.y, res.z, res.h, state.box, LEVEL, CAP,
            n_valid=res.end_index, const_h=True)
        res = dataclasses.replace(res, overflow=torch.maximum(res.overflow, cell_ovf.long()))
        return state, counts, res

    def warm(caps):
        domain = Domain(bucket_size=BUCKET, tree_capacity=caps["tree"], device=dev)
        state = domain.init_state(box=box, boundaries=(1, 1, 1))
        state, counts, res = step(domain, state, x, y, z)
        return domain, state, counts, res

    stencil.reset_launches()
    t0 = time.perf_counter()
    (domain, state, counts, res), caps = sync_with_retry(warm, {"tree": tree_capacity})
    torch.cuda.synchronize()
    print(f"warm step (cold tree build): {1e3 * (time.perf_counter() - t0):.3f} ms, "
          f"tree capacity {caps['tree']}, leaves {int(state.global_tree.n_nodes)} [{card}]", flush=True)

    step_ms = []
    sgn = 1.0
    for _ in range(DRIFT_STEPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        x, y, z = ((c + sgn * drift[:, i]) % 1.0 for i, c in enumerate((x, y, z)))
        state, counts, res = step(domain, state, x, y, z)
        end.record()
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
        check(int(res.overflow) == 0, f"overflow {res.overflow_detail.tolist()}")
        sgn = -sgn
    n_owned = int(res.end_index) - int(res.start_index)
    check(n_owned == N, f"owned {n_owned} != {N}")
    mean_nb = float(counts[:N].double().mean())
    expect_nb = N * 4.0 / 3.0 * math.pi * (2 * H) ** 3
    print(f"count steps: {DRIFT_STEPS} x sync+counts, ms/step "
          f"{json.dumps([round(t, 3) for t in step_ms])}, median {np.median(step_ms):.3f} ms, "
          f"{N / (np.median(step_ms) * 1e-3):.4g} particles/s [{card}]", flush=True)
    print(f"mean neighbours {mean_nb:.3f} (expected n*4/3*pi*(2h)^3 = {expect_nb:.3f})", flush=True)
    check(abs(mean_nb - 57.9) <= 0.5, f"mean neighbour count {mean_nb} outside 57.9 +- 0.5")
    cornerstone_ok(state.global_tree, N)

    # SPH density cell path, continuing the same domain state
    m = torch.full((N,), 1.0 / N, dtype=torch.float32, device=dev)
    sph = SphState(domain=state, x=res.x, y=res.y, z=res.z, h=res.h, m=m,
                   n_local=torch.tensor(N, device=dev))
    sph_ms = []
    for _ in range(SPH_STEPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        sph = dataclasses.replace(sph, **{c: (getattr(sph, c) + sgn * drift[:, i]) % 1.0
                                         for i, c in enumerate("xyz")})
        sph, rho, sres = sph_density_step(domain, sph, cell_level=LEVEL, cell_cap=CAP)
        end.record()
        end.synchronize()
        sph_ms.append(start.elapsed_time(end))
        check(int(sres.overflow) == 0, f"SPH overflow {sres.overflow_detail.tolist()}")
        sgn = -sgn
    launches = stencil.launches()  # read right after the main path
    mean_rho = float(rho[int(sres.start_index):int(sres.end_index)].double().mean())
    expect_rho = 1.0 + 1.0 / (math.pi * H ** 3 * N)
    print(f"SPH steps: {SPH_STEPS} x sync+density, ms/step "
          f"{json.dumps([round(t, 3) for t in sph_ms])}, median {np.median(sph_ms):.3f} ms, "
          f"{N / (np.median(sph_ms) * 1e-3):.4g} particles/s [{card}]", flush=True)
    print(f"mean density {mean_rho:.5f} (expected 1 + 1/(pi h^3 n) = {expect_rho:.5f})", flush=True)
    check(abs(mean_rho / expect_rho - 1.0) <= 0.02, "mean density outside 2% of 1 + 1/(pi h^3 n)")
    check(bool(torch.isfinite(rho[:N]).all()), "density has non-finite values")
    cornerstone_ok(sph.domain.global_tree, N)
    print(f"main-path launches: {json.dumps(launches)}", flush=True)
    check(all(v > 0 for v in launches.values()), f"a kernel was not launched: {launches}")

    # kernels vs plain versions on the main path's own last inputs
    planes = ell_inputs(sres.keys, sres.x, sres.y, sres.z, sres.h, sph.domain.box, LEVEL, CAP,
                        mass=sres.properties[0], n_valid=sres.n_with_halos)
    count_err, dens_err = compare_kernels(planes, sph.domain.box, LEVEL)
    px, py, pz, ph, r2, pm, valid = planes
    flags = (True, True, True)
    L = sph.domain.box.lengths
    times = {
        "counts": cuda_time_ms(lambda: stencil.stencil_counts(px, py, pz, r2, valid, L, flags, LEVEL), 20),
        "counts_plain": cuda_time_ms(
            lambda: stencil.stencil_counts_plain(px, py, pz, r2, valid, L, flags, LEVEL), 3),
        "density": cuda_time_ms(
            lambda: stencil.stencil_density(px, py, pz, ph, valid, L, flags, LEVEL, pm), 20),
        "density_plain": cuda_time_ms(
            lambda: stencil.stencil_density_plain(px, py, pz, ph, valid, L, flags, LEVEL, pm), 3),
    }
    print(f"kernel times at level {LEVEL}, cap {CAP}, n {N}: "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items()) + f" [{card}]", flush=True)
    return [
        {"name": "stencil_counts", "route": "cuda", "source": KERNEL_SOURCE, "replaces": REPLACES,
         "launches": launches["stencil_counts"], "max_abs_err": count_err,
         "ms": times["counts"], "plain_ms": times["counts_plain"]},
        {"name": "stencil_density", "route": "cuda", "source": KERNEL_SOURCE, "replaces": REPLACES,
         "launches": launches["stencil_density"], "max_abs_err": dens_err,
         "ms": times["density"], "plain_ms": times["density_plain"]},
    ]


def main():
    import torch

    phase("1 card")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this check needs a GPU")
    card = card_line()
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}", flush=True)
    dev = torch.device("cuda", 0)

    from cstone_tpu_torch.ops import stencil

    phase("2 build")
    t0 = time.perf_counter()
    stencil.load_library()
    print(f"stencil kernel built and loaded in {time.perf_counter() - t0:.3f} s", flush=True)
    for line in stencil.build_log.splitlines():
        if "registers" in line or "spill" in line or "error" in line.lower():
            print("  " + line.strip(), flush=True)

    phase("3 kernel vs plain")
    kernel_vs_plain_phase(dev)

    phase("4 main path")
    kernels = main_path_phase(dev, card)

    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
