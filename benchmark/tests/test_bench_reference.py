"""The plain reference agrees with the port on the CPU: keys, the
cornerstone tree and the neighbour counts of the same positions,
particles on the cube's faces included; and it imports nothing of the
program."""

import ast
import pathlib

import numpy as np
import pytest
import torch

from benchmark import sample
from benchmark.reference.keys import sfc_keys
from benchmark.reference.neighbors import neighbor_counts
from benchmark.reference.octree import cornerstone_tree

REF = pathlib.Path(__file__).resolve().parent.parent / "reference"


def positions(n, seed, steps=3):
    cfg = {"sample": "uniform", "n": n, "sample_seed": seed, "h": 0.01, "box": {"lo": 0.0, "length": 1.0}}
    xyz0, _, drift = sample.draw(cfg, seed + 1, "cpu", 0.2)
    xyz = sample.positions_after(xyz0, drift, steps)
    for c in xyz:  # particles on the faces and at the last float below 1
        c[:3] = torch.tensor([0.0, np.nextafter(np.float32(1), np.float32(0)), 0.5])
    return xyz


@pytest.mark.parametrize("curve", ["hilbert", "morton"])
@pytest.mark.parametrize("n,seed", [(3000, 1), (20000, 2_147_483_659)])
def test_keys_and_tree(n, seed, curve):
    from cstone_tpu_torch.sfc import PERIODIC, make_box
    from cstone_tpu_torch.sfc.encode import compute_sfc_keys
    from cstone_tpu_torch.tree.csarray import compute_octree

    x, y, z = positions(n, seed)
    box = make_box(0.0, 1.0, boundaries=PERIODIC, device="cpu")
    keys = sfc_keys(x, y, z, 0.0, 1.0, curve)
    assert torch.equal(keys, compute_sfc_keys(x, y, z, box, np.uint64, curve))
    tree = compute_octree(torch.sort(keys).values, 64)
    nn = int(tree.n_nodes)
    bounds, counts = cornerstone_tree(keys, 64)
    assert torch.equal(tree.keys[:nn + 1], bounds) and torch.equal(tree.counts[:nn].long(), counts)


@pytest.mark.parametrize("n,seed", [(3000, 3), (20000, 4_000_000_007)])
def test_neighbor_counts(n, seed):
    from cstone_tpu_torch.sfc import PERIODIC, make_box
    from cstone_tpu_torch.traversal import cell_list_neighbor_counts

    x, y, z = positions(n, seed)
    h = torch.full((n,), 0.012 * (2e6 / n) ** (1 / 3))
    keys = sfc_keys(x, y, z, 0.0, 1.0)
    o = torch.argsort(keys)
    box = make_box(0.0, 1.0, boundaries=PERIODIC, device="cpu")
    level = sample.choose_cell_level(1.0, float(h[0]))
    port, ovf = cell_list_neighbor_counts(keys[o], x[o], y[o], z[o], h[o], box, level,
                                          sample.default_cell_cap(n, level, 3) * 2)
    ref = neighbor_counts(x, y, z, h, 0.0, 1.0)
    assert not bool(ovf)
    assert torch.equal(port.long(), ref[o])
    assert abs(float(ref.float().mean()) - 4 / 3 * np.pi * (2 * float(h[0])) ** 3 * n) < 3.0


def test_counts_against_brute_force():
    n = 1500
    x, y, z = positions(n, 9)
    h = torch.full((n,), 0.1)
    d = [(a[:, None] - a[None, :]) for a in (x, y, z)]
    d = [v - torch.round(v) for v in d]  # the minimum image in the unit cube
    brute = ((d[0] * d[0] + d[1] * d[1] + d[2] * d[2]) < 0.04).sum(1) - 1
    assert torch.equal(neighbor_counts(x, y, z, h, 0.0, 1.0), brute)


def test_reference_imports_nothing_of_the_program():
    for path in REF.glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] in ("torch", "math", "itertools", "__future__"), (path.name, name)
