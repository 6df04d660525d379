"""The rank-level contract of the PyTorch port's p2p-mode Domain (the
default exchange mode) on run_ranks threads:

- two ranks with exactly known layouts (tests/test_domain_2ranks.py): the
  8 level-1 octant centers and the 64 level-2 cell centers, bucket 1,
  dealt round-robin; every buffer slot against the hand-made oracle;
- overflow and retry (tests/test_domain_resize.py:98): with small move,
  treelet and halo capacities the 7-entry overflow_detail equals JAX's on
  every rank and is the same on all ranks; sync_with_retry inside
  run_ranks grows the capacities and then equals the run with the default
  capacities, after ranks 0 and 1 gained particles;
- sph_density_step on p2p ranks equals the one-rank run, both routes;
- decomposition.make_sfc_assignment, find_rank and limit_boundary_shifts,
  which the exchange's assignment goes through, against the JAX package's.

Tolerance: exact, except the SPH densities (rtol 1e-5, float sums in
another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cstone_tpu.domain import decomposition as jdec
from cstone_tpu_torch.domain import Domain, decomposition as tdec, sync_with_retry
from cstone_tpu_torch.ops.keys64 import from_numpy, to_numpy
from cstone_tpu_torch.parallel import run_ranks
from cstone_tpu_torch.sfc import PERIODIC, compute_sfc_keys, make_box
from tests.test_domain import brute_force_total
from tests.test_torch_domain import _assert_same
from tests.test_torch_domain_p2p import owned_neighbor_count
from tests.test_torch_domain_pool import (KW, N, N_PER, R, initial, jax_pool_step, port_pool_step,
                                          sph_ranks_match_one_rank)

import torch_threads  # noqa: F401  (two intra-op threads per xdist worker)

SMALL = dict(move_cap=16, treelet_cap=16, halo_req_cap=16, halo_cap=32)


# ---------------------------------------------------------------------------
# two ranks, exact layouts
# ---------------------------------------------------------------------------

def _hilbert_sorted(pos):
    box = make_box(0.0, 1.0, device="cpu")
    p = torch.from_numpy(pos)
    keys = to_numpy(compute_sfc_keys(p[:, 0], p[:, 1], p[:, 2], box, np.uint64))
    return pos[np.argsort(keys)], box


def _two_rank_sync(pos, h_val, box, cap):
    """Each of 2 ranks starts with a round-robin half of the particles:
    per rank (x in layout order, start, end, n_with_halos)."""
    n = pos.shape[0]
    deal = np.arange(n).reshape(n // 2, 2).T

    def rank_fn(comm):
        cols = np.zeros((4, cap), np.float32)
        cols[:3, :n // 2] = pos[deal[comm.rank]].T
        cols[3, :n // 2] = h_val
        d = Domain(comm=comm, bucket_size=1, bucket_size_focus=1, tree_capacity=256, focus_capacity=256,
                   device="cpu")
        _, res = d.sync(d.init_state(box=box, boundaries=box.boundaries), *torch.from_numpy(cols),
                        n_local=n // 2)
        assert int(res.overflow) == 0 and res.halo_record is not None
        return res.x.numpy(), int(res.start_index), int(res.end_index), int(res.n_with_halos)

    return run_ranks(2, rank_fn)


@pytest.mark.parametrize("h_val", [1e-3, 0.3])
def test_2ranks_octants_exact_layout(h_val):
    # every octant touches every other, so each rank's buffer holds all 8
    # particles in Hilbert order, its own half bracketed by start/end
    g = np.array([0.25, 0.75])
    pos, box = _hilbert_sorted(np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3).astype(np.float32))
    for r, (xs, start, end, nwh) in enumerate(_two_rank_sync(pos, h_val, box, 16)):
        assert (nwh, end - start, start) == (8, 4, 4 * r)
        np.testing.assert_array_equal(xs[:8], pos[:, 0])


def test_2ranks_level2_halo_set_matches_adjacency_oracle():
    # 64 cells split 32/32 with tiny h: the halos are exactly the remote
    # cells sharing a face, edge or corner with the rank's own cells
    g = (np.arange(4) + 0.5) / 4.0
    pos, box = _hilbert_sorted(np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3).astype(np.float32))
    grid = np.floor(pos * 4).astype(int)
    for r, (xs, start, end, nwh) in enumerate(_two_rank_sync(pos, 1e-3, box, 128)):
        own = np.arange(32 * r, 32 * (r + 1))
        adj = [c for c in np.setdiff1d(np.arange(64), own) if (np.abs(grid[c] - grid[own]).max(axis=1) <= 1).any()]
        expected = np.sort(np.concatenate([own, adj]))
        assert 0 < len(adj) < 32 and nwh == len(expected) and end - start == 32
        np.testing.assert_array_equal(xs[:nwh], pos[expected, 0])


# ---------------------------------------------------------------------------
# overflow and retry
# ---------------------------------------------------------------------------

def test_p2p_overflow_detail_matches_jax():
    # small move, treelet and halo capacities: each reported as the size
    # it needs, the largest of all ranks, as JAX reports it
    cols, ids, _, _ = initial()
    n_local = [N_PER] * R
    jout = jax_pool_step(False, mode="p2p", **SMALL)(None, cols, n_local, ids)
    touts = port_pool_step(False, mode="p2p", **SMALL)(None, cols, n_local, ids)
    want = np.asarray(jout[1].overflow_detail)
    for r, t in enumerate(touts):
        res = t[1]
        np.testing.assert_array_equal(res.overflow_detail.numpy(), want[r], err_msg=f"rank {r}")
        np.testing.assert_array_equal(res.overflow_detail.numpy(), want[0])
        assert int(res.overflow) == int(np.asarray(jout[1].overflow)[r])
    detail = touts[0][1].overflow_detail.tolist()
    assert detail[3] > SMALL["move_cap"] and detail[4] > SMALL["treelet_cap"] and detail[5] > SMALL["halo_cap"]
    assert detail[6] == 0


def _retry_sync(cols, n_local, caps0):
    """Each rank's sync_with_retry from caps0 on its slice of `cols`, inside
    one run_ranks call: per rank ((state, domain, result), final caps)."""

    def rank_fn(comm):
        def run(caps):
            d = Domain(comm=comm, device="cpu", bucket_size=KW["bucket_size"],
                       bucket_size_focus=KW["bucket_size_focus"], tree_capacity=caps["tree"],
                       focus_capacity=caps["focus"], move_cap=caps["move"], treelet_cap=caps["treelet"],
                       halo_req_cap=caps["halo"], halo_cap=caps["halo"])
            c = torch.from_numpy(np.ascontiguousarray(cols[:, comm.rank, :caps["local"]]))
            tbox = make_box(0.0, 1.0, boundaries=PERIODIC, device="cpu")
            state, res = d.sync(d.init_state(box=tbox, boundaries=tbox.boundaries), *c[:4],
                                properties=(c[4],), n_local=n_local[comm.rank])
            return state, d, res

        return sync_with_retry(run, caps0)

    return run_ranks(R, rank_fn)


def _uniform_cols(rng, counts, cap):
    cols = np.zeros((5, R, cap), np.float32)
    for r, n in enumerate(counts):
        cols[:3, r, :n] = rng.uniform(0.0, 1.0, size=(3, n))
        cols[3, r, :n] = 0.06
        cols[4, r, :n] = 1.0
    return cols


def test_p2p_sync_with_retry_inside_run_ranks():
    # 8 ranks of 120 particles after ranks 0 and 1 gained 240 and 120
    # (tests/test_domain_resize.py:98's second epoch): each rank retries
    # from small p2p capacities, every rank grows the same ones, and the
    # layout equals the sync at the default capacities; the neighbour
    # counts over the owned slots sum to the brute-force total
    rng = np.random.RandomState(59)
    n_per, cap = 120, 720
    big = {"local": cap, "tree": 1024, "focus": 2048, "move": 0, "treelet": 0, "halo": 0}
    small = dict(big, move=SMALL["move_cap"], treelet=SMALL["treelet_cap"], halo=SMALL["halo_cap"])
    counts = [3 * n_per, 2 * n_per] + [n_per] * (R - 2)
    cols = _uniform_cols(rng, counts, cap)
    got = _retry_sync(cols, counts, small)
    want = _retry_sync(cols, counts, big)
    caps = [c for _, c in got]
    assert all(c == caps[0] for c in caps)
    assert all(caps[0][k] > small[k] for k in ("move", "treelet", "halo")), caps[0]
    assert all(c == big for _, c in want)
    pos = np.concatenate([cols[:3, r, :n].T for r, n in enumerate(counts)])
    h = np.concatenate([cols[3, r, :n] for r, n in enumerate(counts)])
    total = 0
    for r, (((state, d, res), _), ((_, _, ref), _)) in enumerate(zip(got, want)):
        assert int(res.overflow) == 0 and int(ref.overflow) == 0
        # the focus capacity may have grown too (counts lost to a short
        # treelet capacity over-refine the tree): compare the leaves
        nl = int(ref.tree.n_leaf)
        assert int(res.tree.n_leaf) == nl
        for f, n in (("start_index", None), ("end_index", None), ("n_with_halos", None), ("layout", nl + 1),
                     ("halo_flags", nl), ("leaf_counts", nl)):
            _assert_same(getattr(ref, f).numpy(), getattr(res, f), f"rank {r}: {f}", n)
        _assert_same(ref.tree.leaves[:nl + 1].numpy(), res.tree.leaves[:nl + 1], f"rank {r}: leaves")
        nwh = int(res.n_with_halos)
        for f in ("keys", "x", "y", "z", "h"):
            _assert_same(getattr(ref, f)[:nwh].numpy(), getattr(res, f)[:nwh], f"rank {r}: {f}")
        total += owned_neighbor_count(d, state, res)
    assert sum(int(r.end_index) - int(r.start_index) for ((_, _, r), _) in got) == sum(counts)
    limits = got[0][0][0].box.limits.numpy()
    assert total == brute_force_total(pos, h, limits, True)


# ---------------------------------------------------------------------------
# SPH on p2p ranks, decomposition helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route", ["cell", "tree"])
def test_sph_density_step_on_p2p_ranks_matches_one_rank(route):
    sph_ranks_match_one_rank(route, "p2p")


def test_decomposition_helpers_match_jax():
    rng = np.random.RandomState(13)
    n_leaves = 60
    inner = np.unique(rng.randint(1, 2**62, size=n_leaves - 1).astype(np.uint64) * np.uint64(2))
    assert inner.size == n_leaves - 1
    tree = np.concatenate([[0], inner, [1 << 63]]).astype(np.uint64)
    counts = rng.randint(0, 50, size=n_leaves).astype(np.int32)
    keys = np.sort(rng.randint(0, 2**62, size=300).astype(np.uint64) * np.uint64(2))
    jold = jdec.make_sfc_assignment(jnp.asarray(tree), jnp.asarray(counts), n_leaves, R)
    told = tdec.make_sfc_assignment(from_numpy(tree), torch.from_numpy(counts), n_leaves, R)
    _assert_same(jold.boundaries, told.boundaries, "boundaries")
    _assert_same(jold.counts, told.counts, "counts")
    _assert_same(jdec.find_rank(jold, jnp.asarray(keys)), tdec.find_rank(told, from_numpy(keys)), "find_rank")
    # a second split with the particles crowded into the first leaves:
    # boundaries may move only into the neighbour's old range
    counts2 = np.where(np.arange(n_leaves) < 12, counts * 10, 0).astype(np.int32)
    jnew = jdec.make_sfc_assignment(jnp.asarray(tree), jnp.asarray(counts2), n_leaves, R)
    tnew = tdec.make_sfc_assignment(from_numpy(tree), torch.from_numpy(counts2), n_leaves, R)
    jlim = jdec.limit_boundary_shifts(jold, jnew, jnp.asarray(tree), jnp.asarray(counts2))
    tlim = tdec.limit_boundary_shifts(told, tnew, from_numpy(tree), torch.from_numpy(counts2))
    _assert_same(jlim.boundaries, tlim.boundaries, "limited boundaries")
    _assert_same(jlim.counts, tlim.counts, "limited counts")
    assert not np.array_equal(to_numpy(tnew.boundaries), to_numpy(tlim.boundaries)), "no boundary was limited"


def test_default_p2p_at_one_rank_takes_no_records():
    # at one rank the sorted particles are the owned set: no exchange, no
    # records, the result of the pool mode's single rank
    cols, ids, pos, h = initial(seed=3)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    out = {}
    for mode in ("p2p", "pool"):
        d = Domain(exchange_mode=mode, device="cpu", **KW)
        _, out[mode] = d.sync(d.init_state(), t(pos[:, 0]), t(pos[:, 1]), t(pos[:, 2]), t(h), n_local=N)
    assert out["p2p"].ex_record is None and out["p2p"].halo_record is None
    for f in ("keys", "x", "layout", "leaf_counts", "start_index", "end_index", "n_with_halos"):
        _assert_same(getattr(out["pool"], f).numpy(), getattr(out["p2p"], f), f)
