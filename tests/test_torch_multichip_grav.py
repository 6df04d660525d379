"""The grav steps mode of cstone_tpu_torch.multichip on the CPU: syncGrav
(Domain.sync(grav=True) + update_expansion_centers, multichip.grav_rank)
on 4 ranks in pool, dense, ragged and windowed exchange, over
grav_ranks.grav_setup's clustered particles cut to 8,000 (normal(0, 0.25)
clipped to +-0.99 in the open box [-1, 1], masses uniform(0.5, 1.5), h
0.012, theta 0.4, bucket 64), a cold step and a drift step:

- 4 gloo processes (parallel.dist.spawn_ranks) bit-equal to the same
  function on run_ranks threads: every rank's slot records (assignment,
  focus leaves, buffer size, layout, halo flags, keys), centres, MAC
  spheres, slot ids, capacities, window tries, comm rounds and bytes and
  the readings of the checks;
- every mode at every step held by the rank-local checks
  (grav_ranks.rank_checks) against the one-rank run: overflow 0, the
  owned ids a partition, the rank's own nodes within rtol 1e-5 of the
  one-rank run, every other node within 16 rounding units of the float64
  centre of mass, the p2p modes equal to pool slot for slot; the window
  grown 1 -> 3 by overflow_detail[6];
- the rank-local checks raise on a planted fault: a particle dropped
  from one foreign leaf's centre, an owned range one slot short or one
  slot late;
- a centres' range-sum overflow that no slot of overflow_detail names
  raises with the treelet capacity's name instead of looping;
- `main([... "--grav", "--backend", "nccl"])` without a card raises,
  spawned, under torchrun's environment, or outside both; so does
  grav_rank on a thread rank that names no device."""

import dataclasses

import pytest
import torch

from cstone_tpu_torch import grav_ranks as gr
from cstone_tpu_torch import multichip
from cstone_tpu_torch.parallel import run_ranks
from cstone_tpu_torch.parallel.dist import spawn_ranks

import torch_dist_ranks as ranks
import torch_threads  # noqa: F401  (two intra-op threads per xdist worker)

R, N, STEPS = 4, 8000, 1
MODES = tuple(multichip.STEP_MODES)
CPU = torch.device("cpu")
READINGS = ("owned", "halos", "overflow_detail", "nodes", "shared", "held", "gap", "pos", "mass", "sphere")


@pytest.fixture(scope="module")
def cfg():
    return multichip.grav_config(N, R, STEPS, MODES)


@pytest.fixture(scope="module")
def threads(cfg):
    """multichip.grav_rank on run_ranks threads on the CPU, each rank's
    records beside its numbers (ranks.keep_grav_records)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(multichip, "grav_rank_steps", ranks.keep_grav_records(multichip.grav_rank_steps))
        outs = run_ranks(R, multichip.grav_rank, [cfg] * R, [CPU] * R)
    return [dict(o, records=ranks.KEPT.pop(r)) for r, o in enumerate(outs)]


def _same(a, b, what):
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b), what
    else:
        assert a == b, what


def _same_comm(a, b, what):
    # DistComm's ragged round moves its write offsets in one all_to_all of
    # its own, which the tally counts
    _same(dict(a, all_to_all=a["all_to_all"] + a["ragged"], all_to_all_bytes=0), dict(b, all_to_all_bytes=0), what)
    assert b["all_to_all_bytes"] - a["all_to_all_bytes"] == 8 * R * a["ragged"], what


def test_processes_equal_threads(cfg, threads):
    got = spawn_ranks(R, ranks.grav_rank_kept, [cfg] * R, backend="gloo", device="cpu", timeout=60.0,
                      deadline=300.0)
    for r in range(R):
        want, run = threads[r], got[r]
        _same(want["reference"]["caps"], run["reference"]["caps"], f"rank {r}: the one-rank capacities")
        assert want["reference"]["oracle_gap"] == run["reference"]["oracle_gap"]
        for name in MODES:
            a, b = want["modes"][name], run["modes"][name]
            for k in ("caps", "window", "tries"):
                _same(a[k], b[k], f"rank {r}, {name}: {k}")
            for step, (x, y) in enumerate(zip(a["steps"], b["steps"])):
                what = f"rank {r}, {name}, step {step}"
                for k in READINGS:
                    _same(x[k], y[k], f"{what}: {k}")
                _same_comm(x["comm"], y["comm"], f"{what}: the sync's rounds")
                _same_comm(x["centers_comm"], y["centers_comm"], f"{what}: the centres' rounds")
            for step, (x, y) in enumerate(zip(want["records"][name], run["records"][name])):
                assert x.keys() == y.keys()
                for k in x:
                    _same(x[k], y[k], f"rank {r}, {name}, step {step}: {k}")


@pytest.mark.parametrize("name", MODES)
def test_every_step_within_the_rank_checks(threads, name):
    for step in range(1 + STEPS):
        per = [t["modes"][name]["steps"][step] for t in threads]
        assert sum(x["owned"] for x in per) == N
        for r, x in enumerate(per):
            assert x["overflow_detail"] == [0] * 7
            assert 0 < x["held"] < x["nodes"] and x["gap"] <= gr.CENTER_RTOL, (r, step)
            assert max(x["pos"], x["mass"]) <= gr.OUTSIDE_UNITS and x["sphere"] == 0, (r, step)
            assert x["owned"] + x["halos"] <= N
        # the foreign leaves are float32 range sums: off the oracle, within the limit
        assert max(max(x["pos"], x["mass"]) for x in per) > 0
        for r, t in enumerate(threads):
            # the p2p modes equal pool's slot records (the checks held this)
            want, got = t["records"]["pool"][step], t["records"][name][step]
            for k in ("boundaries", "n_leaf", "n_with_halos", "leaves", "layout", "layout_past_leaves", "halo_flags",
                      "keys"):
                _same(want[k], got[k], f"rank {r}, {name}, step {step}: {k}")
    run = threads[0]["modes"][name]
    if name == "window":
        assert [w for w, _ in run["tries"]] == [1, R - 1] and run["tries"][0][1][6] == R - 1
        assert run["window"] == R - 1 and all(s["comm"]["ppermute"] > 0 for s in run["steps"])
    else:
        assert [w for w, _ in run["tries"]] == [0] and run["window"] == 0
    if name == "ragged":
        assert all(s["comm"]["ragged"] > 0 and s["centers_comm"]["ragged"] > 0 for s in run["steps"])
    assert all(t["launches"] == {k: 0 for k in t["launches"]} for t in threads)


@pytest.fixture(scope="module")
def dense_step():
    """The one-rank run's cold step and the 4 ranks' dense cold step, by
    grav_steps on run_ranks threads."""
    setup = gr.grav_setup(N, CPU)
    ref, _ = gr.grav_steps(None, setup, {"tree": multichip.tree_capacity(N, gr.BUCKET)}, None, 0)
    outs = run_ranks(R, lambda comm: gr.grav_steps(comm, setup, multichip.first_caps(N, R), "p2p", 0))
    return ref[0], gr.step_sums(ref[0]), [o[0][0] for o in outs]


def _drop_one_particle(got, ref, sums, rank):
    """`got` with one foreign leaf's centre summed without its first
    particle, as a range sum that missed a particle would give it."""
    leaf = gr._leaf_sums(got, sums, rank)
    t = got["res"].tree
    i = int(torch.nonzero(leaf["foreign"] & (leaf["hi"] - leaf["lo"] >= 2))[0, 0])
    vals = sums["vals"][int(leaf["lo"][i]) + 1:int(leaf["hi"][i])].double().sum(dim=0)
    centers = got["centers"].clone()
    centers[int(t.leaf_order()[i])] = torch.cat([vals[:3] / vals[3], vals[3:]]).float()
    return dict(got, centers=centers)


def _shift_range(got, start, end):
    res = got["res"]
    return dict(got, res=dataclasses.replace(res, start_index=res.start_index + start, end_index=res.end_index + end))


@pytest.mark.parametrize("fault, match", [
    ("none", None),
    ("dropped particle", "rounding units off the float64 oracle"),
    ("range end short", "not a partition"),
    ("range start late", "not a partition"),
])
def test_rank_checks_raise_on_a_planted_fault(dense_step, fault, match):
    ref, sums, outs = dense_step
    bad = 1

    def rank_fn(comm, got):
        if comm.rank == bad:
            if fault == "dropped particle":
                got = _drop_one_particle(got, ref, sums, comm.rank)
            elif fault == "range end short":
                got = _shift_range(got, 0, -1)
            elif fault == "range start late":
                got = _shift_range(got, 1, 0)
        return gr.rank_checks(f"planted {fault}", comm, got, ref, sums)

    if match is None:
        cmp = run_ranks(R, rank_fn, outs)
        assert all(c["gap"] <= gr.CENTER_RTOL and max(c["pos"], c["mass"]) <= gr.OUTSIDE_UNITS for c in cmp)
    else:
        with pytest.raises(RuntimeError, match=match):
            run_ranks(R, rank_fn, outs)


def test_an_unnamed_centres_overflow_raises_with_the_treelet_capacity(monkeypatch):
    # the centres' range-sum service has no slot in overflow_detail (as in
    # the JAX package): a retry would grow nothing, so the cold step names
    # the capacity and stops
    from cstone_tpu_torch.domain import domain as domain_module

    real = domain_module.range_sum_service

    def short(*args, **kw):
        sums, _ = real(*args, **kw)
        return sums, torch.tensor(12345)

    monkeypatch.setattr(domain_module, "range_sum_service", short)
    setup = gr.grav_setup(2000, CPU)
    with pytest.raises(RuntimeError, match="needs 12345 foreign leaves from one owner, above its treelet capacity"):
        run_ranks(R, lambda comm: gr.grav_steps(comm, setup, multichip.first_caps(2000, R), "p2p", 0))


@pytest.mark.skipif(torch.cuda.is_available(), reason="holds what a thread rank does without a card")
def test_a_thread_rank_names_no_device_and_goes_to_the_card(cfg):
    # a run_ranks thread rank's comm names no device: grav_rank takes the
    # card unless the caller names the CPU, and raises without one
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        run_ranks(R, multichip.grav_rank, [cfg] * R)


def test_nccl_without_a_card_raises(monkeypatch):
    argv = ["--steps", "1", "--grav", "--backend", "nccl", "--n-total", "8000"]
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="RANK is not set"):
        multichip.main(argv)
    with pytest.raises(ValueError, match="one card a rank"):
        multichip.main(["--ranks", "4"] + argv)
    for k, v in {"RANK": "0", "WORLD_SIZE": "4", "LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "4",
                 "MASTER_ADDR": "localhost", "MASTER_PORT": "1"}.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match="one card a rank"):
        multichip.main(argv)
    assert not torch.distributed.is_initialized()
    with pytest.raises(SystemExit):
        multichip.main(["--grav", "--backend", "gloo"])  # --grav needs --steps
