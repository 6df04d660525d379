"""The SPH density deployment (the cell uniform-2M.density) at a few
thousand particles on the CPU: the port's `models.sph.sph_density` and
`sph_density_step` against the benchmark's plain reference
(benchmark/reference/density.py) within the comparison's written bound
(benchmark/reference/compare_density.py), in a periodic and an open box,
with seeded random positions, radii and masses; `sph_density_step` equal
bit for bit to a sync followed by `sph_density`, on both routes; the
bound refusing the bfloat16 control, a density without the self term and
one that takes m_i in place of m_j; the reference's neighbours equal to
an O(n^2) count; the traffic module's contract; and the cell run end to
end through `benchmark.run` on the CPU at a tiny size."""

import json
import math
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import control_density
from benchmark.cells import load_cell, load_module
from benchmark.reference import compare_density
from benchmark.reference.density import INV_PI, sph_density as reference_density
from cstone_tpu_torch.domain import Domain
from cstone_tpu_torch.models import SphState, sph_density, sph_density_step
from cstone_tpu_torch.sfc import PERIODIC, make_box

import torch_threads  # noqa: F401  (two intra-op threads per xdist worker)

REPO = pathlib.Path(__file__).resolve().parent.parent
N = 4000
LEVEL, CAP = 3, 64  # cell side 1/8 >= 2 max(h) = 0.12
TREE_KW = dict(ng_max=128, group_size=32, cand_leaf_cap=128, cand_cap=4096)


def _particles(seed):
    rng = np.random.RandomState(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    pos = rng.uniform(0.0, 1.0, size=(3, N)).astype(np.float32)
    h = rng.uniform(0.045, 0.06, size=N).astype(np.float32)
    m = rng.uniform(0.5, 1.5, size=N).astype(np.float32) / N
    return t(pos[0]), t(pos[1]), t(pos[2]), t(h), t(m)


def _domain_and_state(periodic, seed=3):
    x, y, z, h, m = _particles(seed)
    dom = Domain(bucket_size=16, tree_capacity=1024, device="cpu")
    box = make_box(0.0, 1.0, boundaries=PERIODIC if periodic else 0, device="cpu")
    dstate = dom.init_state(box=box if periodic else None, boundaries=box.boundaries)
    return dom, SphState(domain=dstate, x=x, y=y, z=z, h=h, m=m, n_local=torch.tensor(N))


def _faults(res, rho, m, periodic):
    """Owned particles whose density lies outside the bound of the
    reference's, and the largest gap over its bound."""
    s, e = int(res.start_index), int(res.end_index)
    cut = [a[s:e] for a in (res.x, res.y, res.z, res.h, m)]
    ref, near, _ = reference_density(*cut, 0.0, 1.0, periodic=periodic)
    assert float(near.double().mean()) > 15.0
    gap = (rho[s:e].double() - ref.double()).abs() / compare_density.density_bound(ref, near)
    return int(compare_density.density_faults(rho[s:e], ref, near).sum()), float(gap.max())


@pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "open"])
def test_port_density_within_the_bound_of_the_reference(periodic):
    """Two carried steps of sph_density_step, and sph_density on each
    step's sync with the masses reapplied, through the cell list."""
    dom, state = _domain_and_state(periodic)
    for _ in range(2):
        dstate, res = dom.sync(state.domain, state.x, state.y, state.z, state.h, n_local=state.n_local)
        m = dom.reapply_sync(res, state.m)
        rho, ovf = sph_density(dom, res, dstate.box, m, cell_level=LEVEL, cell_cap=CAP)
        assert not bool(ovf)
        assert _faults(res, rho, m, periodic)[0] == 0
        state, rho_step, res_step = sph_density_step(dom, state, cell_level=LEVEL, cell_cap=CAP)
        assert int(res_step.overflow) == 0
        assert _faults(res_step, rho_step, res_step.properties[0], periodic)[0] == 0


def test_tree_route_within_the_bound_of_the_reference():
    """The tree-traversal route divides r by h where the reference
    multiplies sqrt(d2) by 1 / h, and takes the nearest image by
    rounding, so its terms may differ in the last bit and the bound's
    premise (the same terms) holds only nearly: here its largest gap is
    0.45 of the bound."""
    dom, state = _domain_and_state(True, seed=5)
    _, rho, res = sph_density_step(dom, state, **TREE_KW)
    assert int(res.overflow) == 0
    assert _faults(res, rho, res.properties[0], True)[0] == 0


@pytest.mark.parametrize("route", ["cell list", "tree"])
def test_step_equals_sync_then_density_bit_for_bit(route):
    kw = dict(cell_level=LEVEL, cell_cap=CAP) if route == "cell list" else TREE_KW
    dom, state = _domain_and_state(True, seed=7)
    new, rho, res = sph_density_step(dom, state, **kw)
    dstate, res2 = dom.sync(state.domain, state.x, state.y, state.z, state.h, properties=(state.m,),
                            n_local=state.n_local)
    rho2, ovf = sph_density(dom, res2, dstate.box, res2.properties[0], **kw)
    assert torch.equal(rho, rho2)
    assert int(res.overflow) == int(ovf) == 0
    co = dom.compact_owned
    for field, want in (("x", res2.x), ("y", res2.y), ("z", res2.z), ("h", res2.h), ("m", res2.properties[0])):
        assert torch.equal(getattr(new, field), co(res2, want)), field
    assert int(new.n_local) == int(res2.end_index - res2.start_index)


def test_bound_refuses_the_wrong_densities():
    """At the same small size: the density without the self term, and
    with m_i in place of m_j, each fail the bound for nearly every
    particle (the self term is about 1/12 of a density at ~20
    neighbours)."""
    x, y, z, h, m = _particles(11)
    rho, near, _ = reference_density(x, y, z, h, m, 0.0, 1.0)
    assert int(compare_density.density_faults(rho, rho, near).sum()) == 0
    inv_h = 1.0 / h
    no_self = rho - INV_PI * (m * inv_h * inv_h * inv_h)
    rho_unit, _, _ = reference_density(x, y, z, h, torch.ones_like(m), 0.0, 1.0)
    own_mass = m * rho_unit
    for wrong in (no_self, own_mass):
        assert float(compare_density.density_faults(wrong, rho, near).double().mean()) > 0.9


@pytest.mark.parametrize("seed", [13, 4_000_000_007])
def test_bfloat16_control_is_not_correct(seed):
    """The control at 4,000 particles of the cell's configuration (h
    scaled to keep its 116 neighbours)."""
    cell = load_cell("uniform-2M.density")
    cfg = {**cell["config"], "n": N, "h": 0.012 * (2e6 / N) ** (1 / 3)}
    numbers = control_density.readings({"config": cfg, "traffic": cell["traffic"]}, seed, 3, torch.device("cpu"))
    assert any(numbers[k] > compare_density.LIMITS[k] for k in compare_density.LIMITS)
    assert numbers["density_mismatch"] > 0.9 * N


def test_reference_neighbours_equal_brute_force():
    """near (q < 2) and inner (q < 1) against an O(n^2) count in the
    periodic cube, each candidate moved to its image nearest the target."""
    x, y, z, h, m = _particles(17)
    _, near, inner = reference_density(x, y, z, h, m, 0.0, 1.0)
    xyz = torch.stack([x, y, z])
    want_near, want_inner, edge = torch.zeros(N, dtype=torch.int64), torch.zeros(N, dtype=torch.int64), 0
    for s in range(0, N, 500):
        i = torch.arange(s, s + 500)
        gap = xyz[:, i, None] - xyz[:, None, :]
        d = gap - torch.round(gap)
        q = torch.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]) * (1.0 / h[i])[:, None]
        q[torch.arange(500), i] = float("inf")  # not its own neighbour
        want_near[i], want_inner[i] = (q < 2.0).sum(1), (q < 1.0).sum(1)
        # a pair within a few ulps of a cut may fall either side of it in either arithmetic
        edge += int((((q - 2.0).abs() < 1e-6) | ((q - 1.0).abs() < 1e-6)).sum())
    assert int((near - want_near).abs().sum()) <= edge and int((inner - want_inner).abs().sum()) <= edge


def test_traffic_module_contract():
    cell = load_cell("uniform-2M.density")
    assert cell["chips"] == 1 and cell["traffic"]["step"] == "density"
    assert {m["name"] for m in cell["end_to_end"]} == {"step_rate", "peak_mem_gib", "setup_s"}
    assert {m["name"] for m in cell["per_layer"]} == {"density_ms", "density_roofline"}
    mod = load_module("traffic", "density")
    for name in ("PHASES", "LIMITS", "load_kernels", "setup", "step", "grow", "check"):
        assert hasattr(mod, name), name
    assert mod.PHASES[:4] == ("drift", "sync", "density", "carry")
    assert mod.LIMITS == compare_density.LIMITS and set(mod.LIMITS.values()) == {0}
    m = mod.masses({**cell["config"], "n": 1000}, "cpu")
    assert m.dtype == torch.float32 and float(m.min()) >= 0.5e-3 and float(m.max()) <= 1.5e-3
    assert math.isclose(float(m.double().sum()), 1.0, rel_tol=0.05)
    assert torch.equal(m, mod.masses({**cell["config"], "n": 1000}, "cpu"))



def test_density_config_runs_the_counts_particles():
    """The density deployment is the neighbour benchmark's particles,
    radii, tree and cell list with masses summed: every number of
    uniform-2M-h012 under the same key, nothing cut."""
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    name = next(w["config"] for w in spec["workloads"] if w["name"] == "uniform-2M.density")
    entry = next(c for c in spec["configs"] if c["name"] == name)
    assert entry["name"] == "uniform-2M-h012-density" and entry["reduced"] == []
    counts = json.loads((REPO / "benchmark" / "configs" / "uniform-2M-h012.json").read_text())
    density = json.loads((REPO / entry["file"]).read_text())
    descriptive = {"deployment", "source", "assumed", "kernel", "masses"}
    assert {k: v for k, v in density.items() if k not in descriptive} == \
        {k: v for k, v in counts.items() if k not in descriptive}
    assert density["source"].startswith(entry["source"].split(" ")[0])
    sources = [c["source"] for c in spec["configs"] if c["name"] != entry["name"]]
    assert entry["source"] not in sources

def test_density_roofline_bound():
    from benchmark.roofline_density import density_pass_bound_s

    # operations bind: 1e8 pairs, 2e8 near ends, 2.5e7 inner ends, 2M particles
    ops = 1e8 * 10 + 2e8 * 9 + 2.5e7 * 2
    assert density_pass_bound_s(1e8, 2e8, 2.5e7, 2e6) == pytest.approx(ops / 67e12)
    assert density_pass_bound_s(0, 0, 0, 2e6) == pytest.approx(2e6 * 24 / 3.35e12)


def test_cell_runs_on_the_cpu(tmp_path):
    """The cell's step, check and readers through `benchmark.run --device
    cpu`, on a copy of the benchmark with a 4,000-particle configuration
    of the cell's (h scaled to keep 116 neighbours), traced."""
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    os.symlink(REPO / "cstone_tpu_torch", tmp_path / "cstone_tpu_torch")
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    base = json.loads((REPO / "benchmark" / "configs" / "uniform-2M-h012-density.json").read_text())
    tiny = {**base, "n": N, "h": 0.012 * (2e6 / N) ** (1 / 3), "tree_capacity": 4096, "cell_level": 2}
    (tmp_path / "benchmark" / "configs" / "tiny.json").write_text(json.dumps(tiny))
    spec["configs"].append({"name": "tiny", "source": "https://example.org/tiny", "reduced": ["n"],
                            "file": "benchmark/configs/tiny.json", "why": "a CPU test"})
    spec["workloads"].append({"name": "tiny.density", "config": "tiny", "traffic": "density", "chips": 1,
                              "why": "a CPU test"})
    for m in spec["per_layer"]:
        if m["name"].startswith("density"):
            m["workloads"].append("tiny.density")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    env = dict(os.environ, PYTHONPATH="", OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "tiny.density", "--seed",
                           "3000000019", "--seconds", "1", "--trace", "1", "--device", "cpu"],
                          cwd=tmp_path, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.splitlines()[-1])
    assert line["correct"] and line["compared"]["density_mismatch"] == {"value": 0, "limit": 0}
    assert "density_ms" in line["metrics"] and "density_roofline" not in line["metrics"]  # no card, no roofline
