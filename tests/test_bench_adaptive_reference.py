"""The benchmark's plain reference for radii that vary from particle to
particle (benchmark/reference/neighbors_adaptive.py), on the clustered
sample of the cell gauss-2M.tiered (benchmark/samples/gauss.py) cut to a
few thousand particles: its counts and its work (the unordered pairs
within 2 max(h), those across tiers) equal an O(n^2) count in the
periodic cube, on the sample as drawn (positions clamped onto the faces,
some at exactly 1.0) and after drift steps; the port's tiered cell list
on its plain CPU route equals it exactly; the benchmark's copies of the
tier rules equal the port's; and the reference put in the program's
place and computed in bfloat16 comes out not correct (the control)."""

import json
import pathlib

import numpy as np
import pytest
import torch

from benchmark import control_adaptive, sample, tiers
from benchmark.reference.compare import LIMITS
from benchmark.reference.neighbors_adaptive import neighbor_counts_adaptive, unordered_pairs
from cstone_tpu_torch.ops.keys64 import usort
from cstone_tpu_torch.sfc import PERIODIC, compute_sfc_keys, make_box
from cstone_tpu_torch.traversal import tiered

import torch_threads  # noqa: F401  (two intra-op threads per xdist worker)

CONFIG = json.loads((pathlib.Path(__file__).resolve().parent.parent / "benchmark" / "configs"
                     / "gauss-2M-adaptive-h.json").read_text())


def _cfg(n, neighbours, density_level):
    return {**CONFIG, "n": n, "target_neighbours": neighbours, "density_level": density_level}


def _particles(cfg, seed, steps):
    xyz0, h, drift = sample.draw(cfg, seed, "cpu", 0.2)
    return sample.positions_after(xyz0, drift, steps), h


def _brute(xyz, h, tier, T):
    """O(n^2) in float32: each candidate moved by -1, 0 or +1 side on each
    axis to its image nearest the target, the reference's arithmetic;
    returns (counts, A, B) as neighbors_adaptive defines them."""
    x, y, z = xyz
    n = x.numel()
    r2 = (2.0 * h) * (2.0 * h)
    counts = torch.zeros(n, dtype=torch.int64)
    a, b = torch.zeros(T * T, dtype=torch.int64), torch.zeros(T * T, dtype=torch.int64)
    for s in range(0, n, 500):
        i = torch.arange(s, min(n, s + 500))[:, None]
        ds = []
        for c in (x, y, z):
            gap = c[i].double() - c[None, :].double()
            shift = torch.where(gap > 0.5, 1.0, torch.where(gap < -0.5, -1.0, 0.0)).float()
            ds.append(c[i] - (c[None, :] + shift))
        d2 = ds[0] * ds[0] + ds[1] * ds[1] + ds[2] * ds[2]
        ok = (d2 < r2[i]) & (i != torch.arange(n)[None, :])
        counts[i[:, 0]] = ok.sum(1)
        key = (tier[i] * T + tier[None, :]).expand_as(ok)
        a += torch.bincount(key[ok], minlength=T * T)
        b += torch.bincount(key[ok & (d2 < r2[None, :])], minlength=T * T)
    return counts, a.view(T, T), b.view(T, T)


@pytest.mark.parametrize("seed,steps", [(7, 0), (2_147_483_659, 3)], ids=["as-drawn", "drifted"])
def test_counts_and_work_equal_brute_force(seed, steps):
    cfg = _cfg(4000, 20, 3)
    xyz, h = _particles(cfg, seed, steps)
    if steps == 0:
        assert int((xyz[0] == 1.0).sum()) > 0, "the sample should hold positions on the upper face"
    levels = tiers.choose_tier_levels(h.numpy(), 1.0)
    assert len(levels) == 3
    tier = tiers.tier_index(h, 1.0, levels)
    counts, (a, b) = neighbor_counts_adaptive(*xyz, h, 0.0, 1.0, tier=tier, n_tiers=3, block_pairs=1 << 16)
    want, wa, wb = _brute(xyz, h, tier, 3)
    assert torch.equal(counts, want)
    assert torch.equal(a, wa) and torch.equal(b, wb)
    assert unordered_pairs(a, b) == float(wa.sum()) - float(wb.sum()) / 2.0
    for p, q in ((0, 1), (0, 2), (1, 2)):
        assert unordered_pairs(a, b, (p, q)) == float(wa[p, q] + wa[q, p]) - float(wb[p, q] + wb[q, p]) / 2.0
        assert unordered_pairs(a, b, (p, q)) > 0


def test_port_tiered_counts_equal_the_reference():
    """20,000 particles, three tiers, after two drift steps: the
    port's cell_list_neighbor_counts_tiered (plain routes of B1 and B3 on
    the CPU) against the reference, particle by particle."""
    cfg = _cfg(20000, 20, 3)
    xyz, h = _particles(cfg, 11, 2)
    levels = tiers.choose_tier_levels(h.numpy(), 1.0)
    assert levels == (2, 3, 4)
    pos = torch.stack(xyz, 1).numpy()
    caps, cross = tiers.tier_caps(pos, h.numpy(), 0.0, 1.0, levels)
    box = make_box(0.0, 1.0, boundaries=PERIODIC, device="cpu")
    keys, order = usort(compute_sfc_keys(*xyz, box, np.uint64))
    got, ovf = tiered.cell_list_neighbor_counts_tiered(keys, *(c[order] for c in xyz), h[order], box, levels, caps,
                                                       cross, n_valid=cfg["n"])
    assert not bool(ovf)
    want, _ = neighbor_counts_adaptive(*xyz, h, 0.0, 1.0)
    assert torch.equal(got.long(), want[order])
    assert float(want.double().mean()) > 15.0


def test_tier_rules_equal_the_ports():
    cfg = _cfg(8000, 30, 3)
    xyz, h = _particles(cfg, 5, 1)
    pos, hn = torch.stack(xyz, 1).numpy(), h.numpy()
    levels = tiers.choose_tier_levels(hn, 1.0)
    assert levels == tiered.choose_tier_levels(hn, 1.0, max_tiers=3)
    for slack in (1.15, 1.3):
        assert tiers.tier_caps(pos, hn, 0.0, 1.0, levels, slack) == tiered.tier_caps(pos, hn, (0.0, 1.0), levels,
                                                                                     slack=slack)
    box = make_box(0.0, 1.0, boundaries=PERIODIC, device="cpu")
    assert torch.equal(tiers.tier_index(h, 1.0, levels), tiered._tier_index(h, box, levels))


@pytest.mark.parametrize("seed", [13, 4_000_000_007])
def test_bfloat16_control_is_not_correct(seed):
    cell = {"config": _cfg(4000, 20, 3), "traffic": {"drift_share": 0.2}}
    numbers = control_adaptive.readings(cell, seed, 3, torch.device("cpu"))
    assert any(numbers[k] > LIMITS[k] for k in LIMITS)
    assert numbers["count_mismatch"] > 0
