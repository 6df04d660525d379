"""Target groups (traversal/groups.py) and particle fields
(fields/fields.py) of the PyTorch port against the JAX package, after
tests/test_fields_groups.py.

Tolerance: none; group boundaries and counts are bit-equal to JAX."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cstone_tpu.sfc import PERIODIC, compute_sfc_keys, make_box as jax_make_box
from cstone_tpu.traversal.groups import adaptive_groups as jax_adaptive
from cstone_tpu.traversal.groups import fixed_groups as jax_fixed
from cstone_tpu_torch.fields import ParticleFields, get_fields
from cstone_tpu_torch.sfc import make_box
from cstone_tpu_torch.traversal.groups import adaptive_groups, fixed_groups

import torch_threads  # noqa: F401  (two intra-op threads per xdist worker)


def _same(t, j):
    for f in ("group_start", "group_end", "n_groups"):
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)), err_msg=f)


def test_field_states_lifecycle():
    d = ParticleFields(100, device="cpu")
    d.add("x", conserved=True)
    d.add("rho")
    assert d.states.is_allocated("x") and d.states.is_allocated("rho")
    with pytest.raises(ValueError):
        d.release("x")
    buf = d["rho"]
    d.release("rho")
    assert not d.states.is_allocated("rho") and d.states.state("rho") == "released"
    d.acquire("p")  # reuses rho's buffer
    assert d["p"] is buf
    d.acquire("q", dtype=torch.float64)  # no pooled float64 buffer: fresh zeros
    assert d["q"].dtype == torch.float64 and d["q"].device.type == "cpu"
    x, p = get_fields(d, "x", "p")
    assert x.shape == (100,) and x.device.type == "cpu"
    assert d.field_index("y", ["x", "y", "z"]) == 1
    d["v"] = torch.ones(100)
    assert d.states.conserved() == ["x"] and set(d.states.dependent()) == {"p", "q", "v"}


@pytest.mark.parametrize("first,last,size,cap", [(10, 75, 16, 8), (0, 200, 32, 4), (5, 5, 8, 3)])
def test_fixed_groups_match_jax(first, last, size, cap):
    _same(fixed_groups(first, last, group_size=size, cap_groups=cap, device="cpu"),
          jax_fixed(first, last, group_size=size, cap_groups=cap))
    t = fixed_groups(torch.tensor(first), torch.tensor(last), group_size=size, cap_groups=cap)
    _same(t, jax_fixed(first, last, group_size=size, cap_groups=cap))


def test_adaptive_groups_two_clusters_match_jax():
    rng = np.random.RandomState(2)
    n = 200
    x = np.sort(np.concatenate([rng.uniform(0, 0.1, 100), rng.uniform(0.9, 1.0, 100)])).astype(np.float32)
    y = np.zeros(n, np.float32)
    z = np.zeros(n, np.float32)
    j = jax_adaptive(jnp.asarray(x), jnp.asarray(y), jnp.asarray(z), 0, n, max_group_size=32,
                     distance_tol=0.2, box=jax_make_box(0.0, 1.0), cap_groups=64)
    t = adaptive_groups(*(torch.from_numpy(a) for a in (x, y, z)), 0, n, max_group_size=32, distance_tol=0.2,
                        box=make_box(0.0, 1.0, device="cpu"), cap_groups=64)
    _same(t, j)
    ng = int(t.n_groups)
    starts, ends = t.group_start[:ng].numpy(), t.group_end[:ng].numpy()
    assert starts[0] == 0 and ends[-1] == n and 100 in set(starts.tolist())
    np.testing.assert_array_equal(starts[1:], ends[:-1])
    assert (ends - starts).max() <= 32


@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("first,last,cap", [(0, 1500, 512), (37, 1290, 512), (0, 1500, 20)])
def test_adaptive_groups_sfc_sorted_match_jax(periodic, first, last, cap):
    rng = np.random.RandomState(5)
    pos = rng.uniform(0, 1, (1500, 3)).astype(np.float32)
    pos[:300] = np.clip(0.5 + 0.01 * rng.randn(300, 3), 0, 0.999).astype(np.float32)
    jbox = jax_make_box(0.0, 1.0, boundaries=PERIODIC if periodic else 0)
    keys = np.asarray(compute_sfc_keys(*(jnp.asarray(pos[:, i]) for i in range(3)), jbox, jnp.uint64))
    pos = pos[np.argsort(keys, kind="stable")]
    cols = [np.ascontiguousarray(pos[:, i]) for i in range(3)]
    j = jax_adaptive(*(jnp.asarray(c) for c in cols), first, last, max_group_size=16, distance_tol=0.03,
                     box=jbox, cap_groups=cap)
    t = adaptive_groups(*(torch.from_numpy(c) for c in cols), first, last, max_group_size=16,
                        distance_tol=0.03, box=make_box(0.0, 1.0, boundaries=int(periodic), device="cpu"),
                        cap_groups=cap)
    _same(t, j)
    assert int(t.n_groups) > 1500 // 16
