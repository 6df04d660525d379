"""Class members and call contracts of the PyTorch port held against the
JAX package under JAX's own names, on the CPU: `Box` equality, hash and
accessors, `IBox.of` / `min_extent`, `LinkedOctree.capacity`, the
top-level `IBox` export, `expand_bits(v, key_dtype)`,
`multi_searchsorted(side=)`, `sort_by_key(is_stable=)` and the offsets
form of `ell_pack`.

Tolerance: every value equal (the port holds integers in int64 where JAX
holds int32 or unsigned types, so values are compared, not dtypes); the
ELL pack bit-equal."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cstone_tpu
import cstone_tpu_torch
from cstone_tpu.ops import primitives as jprim
from cstone_tpu.sfc import box as jbox
from cstone_tpu.sfc import morton as jmorton
from cstone_tpu.traversal import celllist as jcl
from cstone_tpu.traversal import cover as jcover
from cstone_tpu.tree.octree import LinkedOctree as JaxLinkedOctree
from cstone_tpu_torch.ops import primitives as tprim
from cstone_tpu_torch.ops.keys64 import from_numpy, to_numpy
from cstone_tpu_torch.sfc import compute_sfc_keys
from cstone_tpu_torch.sfc import box as tbox
from cstone_tpu_torch.sfc import morton as tmorton
from cstone_tpu_torch.traversal import celllist as tcl
from cstone_tpu_torch.traversal import cover as tcover
from cstone_tpu_torch.tree.octree import build_linked_octree

import torch_threads  # noqa: F401  (two intra-op threads per xdist worker)

LIMITS = [(-1.0, 2.0, 0.5, 1.5, -3.0, 0.25), (0.0, 1.0, 0.0, 1.0, 0.0, 1.0)]
BOUNDS = [(0, 0, 0), (1, 0, 2)]


def _boxes(limits, bounds):
    return (jbox.Box(jnp.asarray(limits, jnp.float32), bounds),
            tbox.Box(torch.tensor(limits, dtype=torch.float32), bounds))


@pytest.mark.parametrize("other_limits", [0, 1])
@pytest.mark.parametrize("other_bounds", [0, 1])
def test_box_eq_and_hash_match_jax(other_limits, other_bounds):
    ja, ta = _boxes(LIMITS[0], BOUNDS[0])
    jb, tb = _boxes(LIMITS[other_limits], BOUNDS[other_bounds])
    got, want = ta == tb, ja == jb
    assert isinstance(got, bool) and got == want
    assert (ta != tb) == (ja != jb)
    assert (hash(ta) == hash(tb)) == (hash(ja) == hash(jb))
    assert (ta == "a box") is False
    if want:
        assert hash(ta) == hash(tb) and len({ta, tb}) == 1


@pytest.mark.parametrize("name", ["xmin", "xmax", "ymin", "ymax", "zmin", "zmax", "mins", "maxs",
                                  "lengths", "ilengths", "lx", "ly", "lz", "min_extent",
                                  "max_extent", "periodic_mask"])
def test_box_accessors_match_jax(name):
    jb, tb = _boxes(LIMITS[0], BOUNDS[1])
    got, want = getattr(tb, name), getattr(jb, name)
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("args", [(3, 9), (0, 4, 1, 7, 2, 3), (np.array([0, 5]), np.array([8, 6]))])
def test_ibox_of_and_min_extent_match_jax(args):
    jib, tib = jbox.IBox.of(*args), tbox.IBox.of(*args)
    for f in ("xmin", "xmax", "ymin", "ymax", "zmin", "zmax"):
        assert getattr(tib, f).dtype == torch.int64
        np.testing.assert_array_equal(getattr(tib, f).numpy(), np.asarray(getattr(jib, f)))
    np.testing.assert_array_equal(tib.min_extent.numpy(), np.asarray(jib.min_extent))


def test_top_level_exports_match_jax():
    assert "IBox" in cstone_tpu_torch.__all__
    assert cstone_tpu_torch.IBox is tbox.IBox
    assert set(cstone_tpu.__all__) >= {"IBox"}


def test_linked_octree_capacity_matches_jax():
    # the level-1 cornerstone tree of 32-bit keys in a 25-slot array; the
    # JAX dataclass holds the port's arrays (its build compiles for seconds)
    leaves = np.full(26, 1 << 30, dtype=np.uint32)
    leaves[:9] = np.arange(9, dtype=np.uint32) << 27
    tl = build_linked_octree(from_numpy(leaves), torch.tensor(8))
    jl = JaxLinkedOctree(**{f.name: jnp.asarray(getattr(tl, f.name).numpy())
                            for f in dataclasses.fields(JaxLinkedOctree)})
    assert isinstance(tl.capacity, int)
    assert tl.capacity == jl.capacity == tl.prefixes.shape[0]


@pytest.mark.parametrize("key_dtype", [np.uint32, np.uint64])
def test_expand_bits_with_key_dtype_matches_jax(key_dtype):
    rng = np.random.RandomState(5)
    v = rng.randint(0, 1 << 22, size=300).astype(np.int64)
    want = np.asarray(jmorton.expand_bits(jnp.asarray(v), key_dtype)).astype(np.uint64)
    got = tmorton.expand_bits(torch.from_numpy(v), key_dtype).numpy().view(np.uint64)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("side,sides", [("left", None), ("right", None),
                                        ("left", ["right", "left"]), ("right", ["left", "right"])])
def test_multi_searchsorted_side_matches_jax(side, sides):
    rng = np.random.RandomState(7)
    a = np.sort(rng.randint(0, 50, size=64)).astype(np.int32)
    queries = [rng.randint(-2, 55, size=n).astype(np.int32) for n in (17, 9)]
    kw = dict(side=side) if sides is None else dict(side=side, sides=sides)
    want = jprim.multi_searchsorted(jnp.asarray(a), [jnp.asarray(q) for q in queries], **kw)
    got = tprim.multi_searchsorted(torch.from_numpy(a), [torch.from_numpy(q) for q in queries], **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("is_stable", [True, False])
def test_sort_by_key_is_stable_matches_jax(is_stable):
    rng = np.random.RandomState(9)
    keys = rng.randint(0, 12, size=200).astype(np.int32)
    vals = np.arange(200, dtype=np.int32)
    jk, (jv,) = jprim.sort_by_key(jnp.asarray(keys), jnp.asarray(vals), is_stable=is_stable)
    tk, (tv,) = tprim.sort_by_key(torch.from_numpy(keys), torch.from_numpy(vals), is_stable=is_stable)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    if is_stable:  # an unstable sort may order equal keys either way
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    else:
        assert np.array_equal(np.sort(tv.numpy()), vals)
        np.testing.assert_array_equal(keys[tv.numpy()], tk.numpy())


@pytest.mark.parametrize("n_valid,over", [(None, 0), (700, 1)])
def test_ell_pack_offsets_form_matches_jax(n_valid, over):
    # build_cell_table's offsets -> ell_pack, JAX's contract, bit for bit,
    # at a cap that holds the fullest cell and at one below it
    rng = np.random.RandomState(11)
    n, level = 900, 2
    pos = np.clip(rng.normal(0.5, 0.2, size=(n, 3)), 0.0, 1.0).astype(np.float32)
    h = rng.uniform(0.01, 0.05, size=n).astype(np.float32)
    box = tbox.make_box(0.0, 1.0, boundaries=1, device="cpu")
    keys = to_numpy(compute_sfc_keys(*(torch.from_numpy(pos[:, i].copy()) for i in range(3)), box,
                                     np.uint64))
    o = np.argsort(keys, kind="stable")
    keys = keys[o]
    cols = [np.ascontiguousarray(a[o]) for a in (pos[:, 0], pos[:, 1], pos[:, 2], h)]
    joff = jcover.build_cell_table(jnp.asarray(keys), level, n_valid=n_valid)
    toff = tcover.build_cell_table(from_numpy(keys), level, n_valid=n_valid)
    np.testing.assert_array_equal(toff.numpy(), np.asarray(joff))
    jperm, _ = jcl.rowmajor_cell_perm(level)
    tperm, _ = tcl.rowmajor_cell_perm(level, device="cpu")
    cap = int(np.diff(np.asarray(joff)).max()) - over
    jpack = jax.jit(jcl.ell_pack, static_argnums=3)  # one compile, not one per eager op
    jpacked, jvalid, jovf = jpack(joff, jperm, tuple(jnp.asarray(a) for a in cols), cap)
    tpacked, tvalid, tovf = tcl.ell_pack(toff, tperm, tuple(torch.from_numpy(a) for a in cols), cap)
    assert bool(tovf) == bool(jovf) == bool(over)
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    for a, b in zip(jpacked, tpacked):
        np.testing.assert_array_equal(b.numpy().view(np.uint32), np.asarray(a).view(np.uint32))
