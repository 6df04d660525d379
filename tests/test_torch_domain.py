"""Single-rank Domain.sync of the PyTorch port against the JAX package.

Tolerance: bit-equal SyncResult (keys, coordinates, layout, counts, tree,
overflow detail) slot for slot, over three drifting steps with the carried
state: the first call builds everything, later calls take the warm branch
that reuses the carried linked octree."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cstone_tpu_torch
from cstone_tpu.domain.domain import Domain as JaxDomain
from cstone_tpu.sfc import PERIODIC
from cstone_tpu.sfc import make_box as jax_make_box
from cstone_tpu_torch.domain import CAP_NAMES, Domain, sync_with_retry
from cstone_tpu_torch.ops.keys64 import to_numpy
from cstone_tpu_torch.parallel import RankComm
from cstone_tpu_torch.sfc import make_box
from cstone_tpu_torch.tree import root_tree

import torch_threads  # noqa: F401  (two intra-op threads per xdist worker)

N = 3000
CAP_TREE = 1024
RESULT_FIELDS = ("keys", "x", "y", "z", "h", "layout", "leaf_counts", "start_index",
                 "end_index", "n_with_halos", "sort_order", "halo_flags", "overflow",
                 "overflow_detail")
TREE_FIELDS = ("leaves", "prefixes", "child_offsets", "parents", "level_range")


def _assert_same(jax_arr, port_arr, name, n=None):
    a = np.asarray(jax_arr)
    b = to_numpy(port_arr) if a.dtype in (np.uint32, np.uint64) else port_arr.cpu().numpy()
    if n is not None:
        a, b = a[:n], b[:n]
    assert a.shape == b.shape, name
    np.testing.assert_array_equal(b, a, err_msg=name)


def _assert_sync_same(js, jr, ts, tr):
    for f in RESULT_FIELDS:
        _assert_same(getattr(jr, f), getattr(tr, f), f)
    for f in TREE_FIELDS:
        _assert_same(getattr(jr.tree, f), getattr(tr.tree, f), "tree." + f)
    nn = int(jr.tree.n_nodes)
    _assert_same(jr.tree.internal_to_leaf, tr.tree.internal_to_leaf, "internal_to_leaf", nn)
    _assert_same(js.box.limits, ts.box.limits, "box")
    _assert_same(js.global_tree.keys, ts.global_tree.keys, "global_tree.keys")
    _assert_same(js.global_tree.counts, ts.global_tree.counts, "global_tree.counts")
    _assert_same(js.assignment.boundaries, ts.assignment.boundaries, "assignment")
    assert bool(js.focus_converged) == ts.focus_converged


def _particles(seed, n=N):
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    h = rng.uniform(0.04, 0.1, size=n).astype(np.float32)
    drift = rng.uniform(-0.01, 0.01, size=(n, 3)).astype(np.float32)
    return pos, h, drift


def _domains(periodic):
    b = PERIODIC if periodic else 0
    jd = JaxDomain(rank=0, n_ranks=1, bucket_size=16, key_dtype=jnp.uint64,
                   tree_capacity=CAP_TREE)
    td = Domain(bucket_size=16, tree_capacity=CAP_TREE, device="cpu")
    jbox, tbox = jax_make_box(-1.0, 1.0, boundaries=b), make_box(-1.0, 1.0, boundaries=b, device="cpu")
    js = jd.init_state(box=jbox if periodic else None, boundaries=jbox.boundaries)
    ts = td.init_state(box=tbox if periodic else None, boundaries=tbox.boundaries)
    return jd, td, js, ts


def _advance(pos, drift, periodic):
    pos = pos + drift
    return ((pos + 1.0) % 2.0 - 1.0).astype(np.float32) if periodic else pos


def _sync(domain, state, pos, h, port):
    if port:
        cols = [torch.from_numpy(np.ascontiguousarray(pos[:, i])) for i in range(3)]
        return domain.sync(state, *cols, torch.from_numpy(h))
    return domain.sync(state, *(jnp.asarray(pos[:, i]) for i in range(3)), jnp.asarray(h))


@pytest.mark.parametrize("periodic", [True, False])
def test_sync_matches_jax_over_carried_steps(periodic):
    pos, h, drift = _particles(5)
    jd, td, js, ts = _domains(periodic)
    for _ in range(3):
        js, jr = _sync(jd, js, pos, h, port=False)
        ts, tr = _sync(td, ts, pos, h, port=True)
        _assert_sync_same(js, jr, ts, tr)
        assert int(tr.overflow) == 0
        pos = _advance(pos, drift, periodic)


def test_sync_continues_from_jax_state():
    # step 1 in JAX, its state carried into the port, step 2 in both
    pos, h, drift = _particles(9)
    jd, td, js, _ = _domains(True)
    js, _ = _sync(jd, js, pos, h, port=False)
    ts = cstone_tpu_torch.from_numpy_state(js, device="cpu")
    assert ts.first_call is False
    pos = _advance(pos, drift, True)
    js, jr = _sync(jd, js, pos, h, port=False)
    ts, tr = _sync(td, ts, pos, h, port=True)
    _assert_sync_same(js, jr, ts, tr)


def test_sync_reports_tree_overflow_and_retry_grows_it():
    pos, h, _ = _particles(2, n=2000)
    calls = []

    def run(caps):
        calls.append(dict(caps))
        d = Domain(bucket_size=8, tree_capacity=caps["tree"], device="cpu")
        s = d.init_state(box=make_box(-1.0, 1.0, boundaries=PERIODIC, device="cpu"),
                         boundaries=(1, 1, 1))
        _, res = _sync(d, s, pos, h, port=True)
        return res

    res, caps = sync_with_retry(run, {"tree": 64})
    assert int(res.overflow) == 0
    assert len(calls) >= 2 and caps["tree"] > 64
    assert len(res.overflow_detail) == len(CAP_NAMES)


def test_default_device_is_the_card():
    # Domain and the port's other constructors run on the card unless the
    # caller asks for the CPU; without a card the default raises
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for make in (lambda **kw: Domain(bucket_size=16, tree_capacity=256, **kw),
                 lambda **kw: make_box(-1.0, 1.0, **kw),
                 lambda **kw: root_tree(np.uint64, 64, **kw)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
        make(device="cpu")
    d = Domain(bucket_size=16, tree_capacity=256, device="cpu")
    pos, h, _ = _particles(3, n=500)
    state, res = _sync(d, d.init_state(box=make_box(-1.0, 1.0, boundaries=PERIODIC, device="cpu"),
                                       boundaries=(1, 1, 1)), pos, h, port=True)
    assert int(res.overflow) == 0 and state.global_tree.keys.device.type == "cpu"


def test_cuda_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Domain(bucket_size=16, tree_capacity=256, device="cuda")


@pytest.mark.parametrize("kwargs", [dict(comm=RankComm(1, 4), peer_window=2), dict(peer_window=1)])
def test_unported_options_raise(kwargs):
    # the dense rank window, at several ranks (where it would narrow the
    # exchange) and at one
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1, item 4"):
        Domain(bucket_size=16, tree_capacity=256, **kwargs)


@pytest.mark.parametrize("mode", ["p2p", "pool"])
def test_several_ranks_need_a_comm(mode):
    # both exchange modes run at several ranks, through the rank's comm
    with pytest.raises(ValueError, match="comm"):
        Domain(n_ranks=2, exchange_mode=mode, bucket_size=16, tree_capacity=256, device="cpu")
