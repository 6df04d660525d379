"""The half-stencil decomposition of kernels B1/B2 (csrc/stencil_sym.cu),
checked on the CPU through its plain mirror `stencil_sym_plain`: 13 forward
directions plus the centre cell's upper triangle, both ends credited, the
candidate-end d2 taken from its own end across a periodic wrap.

Tolerances: counts bit-equal to the one-sided plain version and to the JAX
roll stencil (impl="xla"); density sums within rtol 1e-5 of the one-sided
plain version (summation order differs)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cstone_tpu.sfc import PERIODIC
from cstone_tpu.sfc import compute_sfc_keys as jax_compute_sfc_keys
from cstone_tpu.sfc import make_box as jax_make_box
from cstone_tpu.traversal import celllist as jcl
from cstone_tpu_torch.ops import stencil
from cstone_tpu_torch.ops.keys64 import from_numpy
from cstone_tpu_torch.sfc import make_box
from cstone_tpu_torch.traversal import celllist as tcl
from cstone_tpu_torch.utils.workloads import wrap_threshold_ell

import torch_threads  # noqa: F401  (two intra-op threads per xdist worker)


def _sample(n, periodic, gauss, seed, hval=None):
    """Key-sorted particles in [-1, 1]^3 with h (per particle unless hval)
    and masses: numpy (x, y, z, h, m, keys), the JAX box and the port box."""
    rng = np.random.RandomState(seed)
    if gauss:
        pos = np.clip(rng.normal(0, 0.3, size=(n, 3)), -0.99, 0.99).astype(np.float32)
    else:
        pos = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    h = (np.full(n, hval) if hval else rng.uniform(0.05, 0.12, size=n)).astype(np.float32)
    m = rng.uniform(0.5, 1.5, size=n).astype(np.float32)
    b = PERIODIC if periodic else 0
    jbox, tbox = jax_make_box(-1.0, 1.0, boundaries=b), make_box(-1.0, 1.0, boundaries=b, device="cpu")
    keys = np.asarray(jax_compute_sfc_keys(*(jnp.asarray(pos[:, i]) for i in range(3)), jbox, jnp.uint64))
    o = np.argsort(keys, kind="stable")
    return (pos[o, 0], pos[o, 1], pos[o, 2], h[o], m[o], keys[o]), jbox, tbox


def _pack(arrs, level):
    x, y, z, h, m, keys = arrs
    occ = np.bincount((keys >> np.uint64(3 * (21 - level))).astype(np.int64))
    cap = 8 * -(-int(occ.max()) // 8)
    perm, _ = tcl.rowmajor_cell_perm(level, device="cpu")
    cols = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in (x, y, z, h, m))
    (px, py, pz, ph, pm), valid, pidx, ovf = tcl.ell_pack_gather(from_numpy(keys), perm, cols, cap, level)
    assert not bool(ovf)
    r2 = torch.where(valid, (2.0 * ph) * (2.0 * ph), -1.0)
    return px, py, pz, ph, r2, torch.where(valid, pm, 0.0), valid, pidx


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("gauss", [False, True])
@pytest.mark.parametrize("per_particle_h", [False, True])
def test_sym_plain_equals_one_sided_plain(periodic, gauss, per_particle_h):
    arrs, _, tbox = _sample(2500, periodic, gauss, seed=11, hval=None if per_particle_h else 0.09)
    level = 3
    px, py, pz, ph, r2, pm, valid, _ = _pack(arrs, level)
    flags, L = (periodic,) * 3, tbox.lengths
    want = stencil.stencil_counts_plain(px, py, pz, r2, valid, L, flags, level)
    got = stencil.stencil_sym_plain(False, px, py, pz, r2, valid, L, flags, level)
    assert int(want.sum()) > 0
    assert torch.equal(got, want)
    for mass in (None, pm):
        want = stencil.stencil_density_plain(px, py, pz, ph, valid, L, flags, level, mass)
        got = stencil.stencil_sym_plain(True, px, py, pz, ph, valid, L, flags, level, mass)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("gauss", [False, True])
def test_sym_plain_matches_jax_xla(periodic, gauss):
    # per-particle counts: the JAX roll stencil through cell_list_neighbor_counts,
    # the port's cell_list_neighbor_counts, and the half-stencil mirror
    arrs, jbox, tbox = _sample(2000, periodic, gauss, seed=29)
    x, y, z, h, _, keys = arrs
    level = tcl.choose_cell_level(tbox, float(h.max()))
    assert level >= 2
    px, py, pz, _, r2, _, valid, pidx = _pack(arrs, level)
    cap = px.shape[1]
    jc, jovf = jcl.cell_list_neighbor_counts(jnp.asarray(keys), *(jnp.asarray(a) for a in (x, y, z, h)),
                                             jbox, level, cap, impl="xla")
    assert not bool(jovf)
    cols = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in (x, y, z, h))
    tc, _ = tcl.cell_list_neighbor_counts(from_numpy(keys), *cols, tbox, level, cap)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    sym = stencil.stencil_sym_plain(False, px, py, pz, r2, valid, tbox.lengths, (periodic,) * 3, level)
    per_particle = torch.zeros(x.shape[0], dtype=torch.int32)
    per_particle[pidx[valid]] = sym[valid]
    np.testing.assert_array_equal(per_particle.numpy(), np.asarray(jc))


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_wrap_pair_uses_each_ends_own_d2(axis):
    planes, valid, level, d2_i, d2_j = wrap_threshold_ell(axis)
    px, py, pz, r2 = torch.from_numpy(planes)
    valid, L = torch.from_numpy(valid), torch.ones(3)
    assert d2_i != d2_j
    # the candidate end j decides by its own d2; a reused d2 would flip it
    assert (d2_j < max(d2_i, d2_j)) != (d2_i < max(d2_i, d2_j))
    flags = (True,) * 3
    want = stencil.stencil_counts_plain(px, py, pz, r2, valid, L, flags, level)
    assert int(want.sum()) == 1
    got = stencil.stencil_sym_plain(False, px, py, pz, r2, valid, L, flags, level)
    assert torch.equal(got, want)
