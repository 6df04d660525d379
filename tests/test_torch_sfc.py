"""SFC keys of the PyTorch port (cstone_tpu_torch.sfc) against the JAX
package and the reference golden vectors. Tolerance: bit-equal."""

import pathlib
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cstone_tpu.sfc import compute_sfc_keys as jax_compute_sfc_keys
from cstone_tpu.sfc import make_box as jax_make_box
from cstone_tpu.sfc.encode import decode_sfc as jax_decode_sfc
from cstone_tpu.sfc.encode import sfc_ibox as jax_sfc_ibox
from cstone_tpu_torch.ops.bits import count_leading_zeros
from cstone_tpu_torch.ops.keys64 import flip, from_numpy, srl, to_numpy
from cstone_tpu_torch.ops.primitives import searchsorted
from cstone_tpu_torch.sfc import compute_sfc_keys, isfc_key, make_box, sfc3d
from cstone_tpu_torch.sfc.encode import decode_sfc, sfc_ibox
from cstone_tpu_torch.sfc.keys import node_range, remove_key, tree_level

import torch_threads  # noqa: F401  (two intra-op threads per xdist worker)

PORT = pathlib.Path(__file__).resolve().parent.parent / "cstone_tpu_torch"


def _coords(n, dist, seed):
    rng = np.random.RandomState(seed)
    if dist == "gauss":
        pos = np.clip(rng.normal(0, 0.25, size=(n, 3)), -0.999, 0.999)
    else:
        pos = rng.uniform(-1, 1, size=(n, 3))
    return pos.astype(np.float32)


@pytest.mark.parametrize("key_dtype", [np.uint32, np.uint64])
@pytest.mark.parametrize("curve", ["hilbert", "morton"])
@pytest.mark.parametrize("dist", ["uniform", "gauss"])
def test_keys_match_jax(key_dtype, curve, dist):
    pos = _coords(4096, dist, seed=11)
    jk = jax_compute_sfc_keys(*(jnp.asarray(pos[:, i]) for i in range(3)),
                              jax_make_box(-1.0, 1.0), key_dtype, curve)
    tk = compute_sfc_keys(*(torch.from_numpy(pos[:, i].copy()) for i in range(3)),
                          make_box(-1.0, 1.0, device="cpu"), key_dtype, curve)
    np.testing.assert_array_equal(to_numpy(tk), np.asarray(jk))


@pytest.mark.parametrize("suffix,key_dtype", [("32", np.uint32), ("64", np.uint64)])
@pytest.mark.parametrize("curve", ["hilbert", "morton"])
def test_integer_keys_golden(golden, suffix, key_dtype, curve):
    ix, iy, iz = (torch.from_numpy(golden[f"i{c}{suffix}"].astype(np.int64)) for c in "xyz")
    keys = isfc_key(ix, iy, iz, key_dtype, curve)
    np.testing.assert_array_equal(to_numpy(keys), golden[f"{curve}{suffix}"])


def test_sfc3d_float32_golden(golden):
    x, y, z = (torch.from_numpy(golden[f"coords_{c}_bits"].view(np.float32).copy()) for c in "xyz")
    box = make_box(-1.0, 1.0, device="cpu")
    np.testing.assert_array_equal(to_numpy(sfc3d(x, y, z, box, np.uint32)), golden["sfc3d_hilbert32"])
    np.testing.assert_array_equal(to_numpy(sfc3d(x, y, z, box, np.uint64)), golden["sfc3d_hilbert64"])


@pytest.mark.parametrize("key_dtype", [np.uint32, np.uint64])
@pytest.mark.parametrize("curve", ["hilbert", "morton"])
def test_decode_and_ibox_match_jax(key_dtype, curve):
    pos = _coords(2048, "gauss", seed=5)
    jk = jax_compute_sfc_keys(*(jnp.asarray(pos[:, i]) for i in range(3)),
                              jax_make_box(-1.0, 1.0), key_dtype, curve)
    tk = from_numpy(np.asarray(jk))
    for a, b in zip(decode_sfc(tk, curve), jax_decode_sfc(jk, curve)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b).astype(np.int64))
    lmax = 10 if key_dtype == np.uint32 else 21
    level = np.random.RandomState(2).randint(0, lmax + 1, size=2048)
    # node start keys at each level: the key with its low bits cleared
    shift = (3 * (lmax - level)).astype(key_dtype)
    starts = np.asarray(jk) >> shift << shift
    jb = jax_sfc_ibox(jnp.asarray(starts), jnp.asarray(level.astype(np.int32)), curve)
    tb = sfc_ibox(from_numpy(starts), torch.from_numpy(level), curve)
    for f in ("xmin", "xmax", "ymin", "ymax", "zmin", "zmax"):
        np.testing.assert_array_equal(getattr(tb, f).numpy(), np.asarray(getattr(jb, f)).astype(np.int64))


def test_unsigned_helpers_match_numpy():
    rng = np.random.RandomState(3)
    u = rng.randint(0, 2**63, size=512, dtype=np.uint64) * np.uint64(2) + rng.randint(0, 2, 512).astype(np.uint64)
    u[:4] = [0, 1, 2**63, 2**64 - 1]
    t = from_numpy(u)
    for s in (0, 1, 3, 48, 63):
        np.testing.assert_array_equal(to_numpy(srl(t, s)), u >> np.uint64(s))
        shifts = torch.full_like(t, s)
        np.testing.assert_array_equal(to_numpy(srl(t, shifts)), u >> np.uint64(s))
    clz = np.array([64 - int(v).bit_length() for v in u])
    np.testing.assert_array_equal(count_leading_zeros(t).numpy(), clz)
    order = torch.argsort(flip(t), stable=True).numpy()
    np.testing.assert_array_equal(u[order], np.sort(u))
    srt = np.sort(u)
    q = u[::7]
    np.testing.assert_array_equal(searchsorted(from_numpy(srt), from_numpy(q)).numpy(),
                                  np.searchsorted(srt, q))


def test_sign_bit_constants():
    # the uint64 values that use the sign bit of the int64 storage
    assert node_range(np.uint64, 0) == -(2**63) == remove_key(np.uint64)
    assert int(tree_level(torch.tensor([node_range(np.uint64, 0)]))[0]) == 0
    assert remove_key(np.uint32) == 2**30


def test_port_source_imports_no_jax():
    bad = re.compile(r"^\s*(import|from)\s+(jax|cstone_tpu)(\.|\s|$)")
    for path in sorted(PORT.rglob("*.py")):
        for line in path.read_text().splitlines():
            assert not bad.match(line), f"{path}: {line}"


def test_port_import_loads_no_jax():
    code = ("import sys, cstone_tpu_torch.models, cstone_tpu_torch.traversal, cstone_tpu_torch.domain, "
            "cstone_tpu_torch.ops.neighbors_v1, cstone_tpu_torch.ops.neighbors_v2, "
            "cstone_tpu_torch.utils.workloads; "
            "assert not [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'cstone_tpu.'))]")
    subprocess.run([sys.executable, "-c", code], cwd=PORT.parent, check=True)
