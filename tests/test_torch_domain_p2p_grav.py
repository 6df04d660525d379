"""p2p-mode syncGrav and update_expansion_centers of the PyTorch port on 8
ranks against the JAX package's p2p mode inside shard_map.

syncGrav: 8 ranks x 200 particles, theta 0.5, local capacity = n (the
inputs of tests/test_torch_domain_pool_grav.py). Tolerance: every rank's
SyncResult bit-equal slot for slot, records included, the halo flags over
the tree's leaves (past n_leaf JAX's grav flags read the MAC mark of the
node its unstable sort left in leaf_to_internal's padding, the port's stay
0); the flags are a superset of the grav=False flags, and diagnostics
equal JAX's.

update_expansion_centers: tests/test_expansion_centers.py's inputs (8 x
200, theta 0.6); leaves and MAC flags bit-equal, centers within the
tolerances stated in tests/test_torch_domain_pool.assert_centers_match."""

import jax.numpy as jnp
import numpy as np
import pytest

from cstone_tpu.domain.domain import Domain as JaxDomain
from cstone_tpu.parallel import rank_axis
from tests.test_torch_domain_p2p import assert_p2p_rank_same
from tests.test_torch_domain_pool import (KW, R, assert_centers_match, expansion_centers_runs, initial, jax_pool_step,
                                          port_pool_step, rank_slice)

import torch_threads  # noqa: F401  (two intra-op threads per xdist worker)

N_PER = 200
CAP = R * N_PER


@pytest.fixture(scope="module")
def runs():
    cols, ids, _, _ = initial(seed=29, h_range=(0.03, 0.06), n_per=N_PER, cap=CAP)
    n_local = [N_PER] * R
    jout = jax_pool_step(False, grav=True, mode="p2p")(None, cols, n_local, ids)
    grav = port_pool_step(False, grav=True, mode="p2p")(None, cols, n_local, ids)
    plain = port_pool_step(False, grav=False, mode="p2p")(None, cols, n_local, ids)
    return jout, grav, plain


def test_grav_p2p_sync_matches_jax_per_rank(runs):
    jout, grav, _ = runs
    for r in range(R):
        assert_p2p_rank_same(jout, grav[r], r, leaves_only=("halo_flags",))
        res = grav[r][1]
        assert int(res.overflow) == 0
        assert not res.halo_flags[int(res.tree.n_leaf):].any()
    assert sum(int(t[3]) for t in grav) == R * N_PER


def test_grav_p2p_halos_are_a_superset(runs):
    # what the flags select: every particle a rank receives as a halo
    # without gravity it also receives with it (the ids exchange_halos put
    # into the halo slots), and the flags count more in all
    _, grav, plain = runs

    def halo_ids(out):
        res, hids = out[1], out[5].numpy()
        j = np.arange(hids.shape[0])
        halo = (j < int(res.n_with_halos)) & ~((j >= int(res.start_index)) & (j < int(res.end_index)))
        return set(hids[halo].tolist())

    for g, p in zip(grav, plain):
        assert halo_ids(p) <= halo_ids(g)
    assert sum(int(g[1].halo_flags.sum()) for g in grav) > sum(int(p[1].halo_flags.sum()) for p in plain)


def test_grav_p2p_diagnostics_match_jax_per_rank(runs):
    jout, grav, _ = runs
    for r in range(R):
        jd = JaxDomain(rank=r, n_ranks=R, key_dtype=jnp.uint64, axis_name=rank_axis, theta=0.5, protocol="dense",
                       **KW)
        want = jd.diagnostics(rank_slice(jout[0], r), rank_slice(jout[1], r))
        got = grav[r][-1].diagnostics(grav[r][0], grav[r][1])
        assert got == want, r
        assert got["mac_peers"] > 0


def test_update_expansion_centers_on_p2p_ranks_matches_jax():
    # foreign leaves are summed by their owners' range-sum service
    assert_centers_match(*expansion_centers_runs("p2p"))
