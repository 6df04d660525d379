"""The Hilbert key codec on the card: the kernel of csrc/sfc.cu (one launch
a call, through sfc/encode.py's dispatch) against the plain codec
(sfc/hilbert.py and encode._grid_coords) run on the same card on the
same inputs, and against the plain codec on the CPU, bit for bit, for
uint32 and uint64 keys; exactly one launch a call, counted by the wrapper
and by the trace counter `sfc.kernel` (`sfc.plain` never).

Cases: the integer encode on 0, cube - 1, single bits and random
coordinates (int32 and int64), and on int64 coordinates outside the grid
as halo boxes give them, through isfc_key and contained_in_keys; ihilbert_top at every level count
with 3*levels <= 30; the decode of random keys, 0 and the last key; the
float encode in a non-unit box on cell edges (min + k L / 2^lmax) and
between them, float32 and float64; compute_sfc_keys with old_keys that
carry remove_key; 0-d, broadcast, non-contiguous and empty inputs.
Skips without an NVIDIA GPU and nvcc; chip_smoke.py's phase 18 runs the
codec at the main path's shapes. Tolerance: keys and coordinates exact."""

import numpy as np
import pytest
import torch

from cstone_tpu_torch.ops import sfc_codec
from cstone_tpu_torch.ops.cuda_lib import nvcc_path
from cstone_tpu_torch.sfc import compute_sfc_keys, make_box
from cstone_tpu_torch.sfc import hilbert as plain
from cstone_tpu_torch.sfc.box import IBox
from cstone_tpu_torch.sfc.encode import _grid_coords, decode_sfc, isfc_key, isfc_key_top, sfc3d
from cstone_tpu_torch.sfc.keys import max_tree_level, remove_key
from cstone_tpu_torch.traversal.boxoverlap import contained_in_keys
from cstone_tpu_torch.utils import trace

pytestmark = pytest.mark.cuda

KEYS = [np.uint32, np.uint64]


@pytest.fixture(scope="module")
def dev():
    try:
        nvcc_path()
    except RuntimeError:
        pytest.skip("needs an NVIDIA GPU and nvcc")
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


def _on_card(fn, *args, launch="encode", n_launches=1):
    """fn(*args) under a trace, checked to launch the kernel `n_launches`
    times and to count one codec call on the kernel route."""
    before = sfc_codec.launches()[launch]
    with trace.collect() as tally:
        out = fn(*args)
    torch.cuda.synchronize()
    assert sfc_codec.launches()[launch] == before + n_launches
    assert tally.read()["counts"] == {"sfc.kernel": 1}
    return out


def _equal(got, want):
    got, want = (got,) if torch.is_tensor(got) else got, (want,) if torch.is_tensor(want) else want
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.cpu(), b.cpu())


def _grid_cases(lmax, rng, n=50_000):
    cube = 1 << lmax
    special = [0, cube - 1] + [1 << b for b in range(lmax)] + [(1 << b) - 1 for b in range(1, lmax)]
    s = np.array(special, dtype=np.int64)
    g = np.meshgrid(s, s, s, indexing="ij")
    c = [np.concatenate([a.ravel(), rng.integers(0, cube, n)]) for a in g]
    return [torch.from_numpy(a) for a in c]


@pytest.mark.parametrize("key_dtype", KEYS)
@pytest.mark.parametrize("coord_dtype", [torch.int32, torch.int64])
def test_integer_encode_equals_plain(dev, key_dtype, coord_dtype):
    lmax = max_tree_level(key_dtype)
    c = [a.to(coord_dtype) for a in _grid_cases(lmax, np.random.default_rng(1))]
    want = plain.ihilbert(*c, key_dtype)
    card = [a.to(dev) for a in c]
    got = _on_card(isfc_key, *card, key_dtype)
    _equal(got, want)
    _equal(got, plain.ihilbert(*card, key_dtype))


@pytest.mark.parametrize("key_dtype", KEYS)
def test_integer_encode_outside_the_grid_equals_plain(dev, key_dtype):
    lmax = max_tree_level(key_dtype)
    cube = 1 << lmax
    rng = np.random.default_rng(7)
    edges = np.array([-cube, -1, 0, 1, cube - 1, cube, 2 * cube - 1])
    g = np.meshgrid(edges, edges, edges, indexing="ij")
    c = [torch.from_numpy(np.concatenate([a.ravel(), rng.integers(-cube, 2 * cube, 20_000)])) for a in g]
    card = [a.to(dev) for a in c]
    got = _on_card(isfc_key, *card, key_dtype)
    _equal(got, plain.ihilbert(*c, key_dtype))
    # node boxes dilated past the grid's faces, as make_halo_box leaves them
    # in a periodic box
    lo = [torch.from_numpy(rng.integers(-cube // 4, cube, 5_000)) for _ in range(3)]
    size = torch.from_numpy(rng.integers(1, cube // 2, 5_000))
    box = IBox(lo[0], lo[0] + size, lo[1], lo[1] + size, lo[2], lo[2] + size)
    on_card = IBox(*(getattr(box, f).to(dev) for f in ("xmin", "xmax", "ymin", "ymax", "zmin", "zmax")))
    span = 1 << 3 * lmax
    for first, last in ((0, span // 2), (span // 8, span // 4 * 3)):
        want = contained_in_keys(box, first, last, key_dtype)
        before = sfc_codec.launches()["encode"]
        got = contained_in_keys(on_card, first, last, key_dtype)
        assert sfc_codec.launches()["encode"] == before + 2
        _equal(got, want)


@pytest.mark.parametrize("key_dtype", KEYS)
def test_ihilbert_top_at_every_level_count(dev, key_dtype):
    lmax = max_tree_level(key_dtype)
    c = _grid_cases(lmax, np.random.default_rng(2), n=20_000)
    card = [a.to(dev) for a in c]
    full = plain.ihilbert(*c, key_dtype).to(torch.int64)
    for levels in range(0, 11):
        got = _on_card(isfc_key_top, *card, levels, lmax)
        want = plain.ihilbert_top(*c, levels, lmax)
        _equal(got, want)
        _equal(got, plain.ihilbert_top(*card, levels, lmax))
        mask = (1 << 3 * max_tree_level(key_dtype)) - 1
        assert torch.equal(want, (full & mask) >> 3 * (lmax - levels))


@pytest.mark.parametrize("key_dtype", KEYS)
def test_decode_equals_plain(dev, key_dtype):
    lmax = max_tree_level(key_dtype)
    rng = np.random.default_rng(3)
    if key_dtype == np.uint64:
        raw = rng.integers(0, 1 << 63, 100_000, dtype=np.uint64) * np.uint64(2) + rng.integers(0, 2, 100_000).astype(
            np.uint64)
        keys = torch.from_numpy(raw.view(np.int64))
    else:
        keys = torch.from_numpy(rng.integers(0, 1 << 32, 100_000).astype(np.uint32).view(np.int32))
    last = (1 << 3 * lmax) - 1
    keys[:3] = torch.tensor([0, last, remove_key(key_dtype)], dtype=keys.dtype)
    got = _on_card(decode_sfc, keys.to(dev), launch="decode")
    _equal(got, plain.decode_hilbert(keys))
    _equal(got, plain.decode_hilbert(keys.to(dev)))
    # the decode inverts the encode
    cube = 1 << lmax
    assert [int(a[1]) for a in got] != [0, 0, 0] and all(0 <= int(a.max()) < cube for a in got)
    valid = keys[(keys >= 0) & (keys <= last)]
    back = isfc_key(*decode_sfc(valid.to(dev)), key_dtype)
    assert torch.equal(back.cpu(), valid)


@pytest.mark.parametrize("key_dtype", KEYS)
@pytest.mark.parametrize("fdt", [torch.float32, torch.float64])
def test_float_encode_on_cell_edges_equals_plain(dev, key_dtype, fdt):
    lmax = max_tree_level(key_dtype)
    box = make_box(-1.5, 2.25, -0.75, 0.5, 3.0, 7.125, device="cpu")
    lo, hi = box.mins.double().numpy(), box.maxs.double().numpy()
    rng = np.random.default_rng(4)
    n = 60_000
    k = rng.integers(0, (1 << lmax) + 1, (n, 3))
    edges = lo + k * ((hi - lo) / (1 << lmax))  # on cell edges, the box's upper faces included
    inner = rng.uniform(lo, hi, (n, 3))
    pos = np.concatenate([edges, np.nextafter(edges, -np.inf), np.nextafter(edges, np.inf), inner, [lo, hi]])
    xyz = [torch.from_numpy(pos[:, d].copy()).to(fdt) for d in range(3)]
    card = [a.to(dev) for a in xyz]
    dbox = make_box(-1.5, 2.25, -0.75, 0.5, 3.0, 7.125, device=dev)
    got = _on_card(sfc3d, *card, dbox, key_dtype)
    _equal(got, plain.ihilbert(*_grid_coords(*xyz, box, key_dtype), key_dtype))
    _equal(got, plain.ihilbert(*_grid_coords(*card, dbox, key_dtype), key_dtype))


@pytest.mark.parametrize("key_dtype", KEYS)
def test_compute_sfc_keys_keeps_remove_key(dev, key_dtype):
    rng = np.random.default_rng(5)
    pos = torch.from_numpy(rng.uniform(0, 1, (10_000, 3)).astype(np.float32))
    box = make_box(0.0, 1.0, device="cpu")
    old = torch.zeros(10_000, dtype=torch.int64 if key_dtype == np.uint64 else torch.int32)
    old[::7] = remove_key(key_dtype)
    want = compute_sfc_keys(*pos.unbind(1), box, key_dtype, old_keys=old)
    got = _on_card(compute_sfc_keys, *pos.to(dev).unbind(1), make_box(0.0, 1.0, device=dev), key_dtype, "hilbert",
                   old.to(dev))
    _equal(got, want)
    assert int((got == remove_key(key_dtype)).sum()) == len(range(0, 10_000, 7))


@pytest.mark.parametrize("key_dtype", KEYS)
def test_zero_dim_broadcast_non_contiguous_and_empty_inputs(dev, key_dtype):
    lmax = max_tree_level(key_dtype)
    rng = np.random.default_rng(6)
    grid = torch.from_numpy(rng.integers(0, 1 << lmax, (3, 64, 5)))
    # 0-d
    c0 = [torch.tensor(int(v)) for v in grid[:, 0, 0]]
    _equal(_on_card(isfc_key, *(a.to(dev) for a in c0), key_dtype), plain.ihilbert(*c0, key_dtype))
    # broadcast: a column, a row and a 0-d value
    cb = (grid[0, :, :1], grid[1, :1, :], grid[2, 0, 0])
    got = _on_card(isfc_key, *(a.to(dev) for a in cb), key_dtype)
    assert got.shape == (64, 5)
    _equal(got, plain.ihilbert(*cb, key_dtype))
    # non-contiguous: transposed and strided views
    cn = [a.to(dev).t()[:, ::2] for a in grid]
    assert not cn[0].is_contiguous()
    _equal(_on_card(isfc_key, *cn, key_dtype), plain.ihilbert(*(a.t()[:, ::2] for a in grid), key_dtype))
    keys = plain.ihilbert(*grid, key_dtype)
    _equal(_on_card(decode_sfc, keys.to(dev).t(), launch="decode"), plain.decode_hilbert(keys.t()))
    pos = torch.from_numpy(rng.uniform(0, 1, (32, 3)))
    box, dbox = make_box(0.0, 1.0, device="cpu"), make_box(0.0, 1.0, device=dev)
    _equal(_on_card(sfc3d, *pos.to(dev).unbind(1), dbox, key_dtype), sfc3d(*pos.unbind(1), box, key_dtype))
    # empty: no launch, empty results of the plain codec's dtypes and shapes
    e = torch.zeros((0, 4), dtype=torch.int64)
    _equal(_on_card(isfc_key, e.to(dev), e.to(dev), e.to(dev), key_dtype, n_launches=0),
           plain.ihilbert(e, e, e, key_dtype))
    ek = torch.zeros(0, dtype=keys.dtype)
    _equal(_on_card(decode_sfc, ek.to(dev), launch="decode", n_launches=0), plain.decode_hilbert(ek))
    ef = torch.zeros(0, dtype=torch.float32)
    _equal(_on_card(sfc3d, ef.to(dev), ef.to(dev), ef.to(dev), dbox, key_dtype, n_launches=0),
           sfc3d(ef, ef, ef, box, key_dtype))


def test_launch_counts_rise_once_a_call(dev):
    c = [torch.arange(1000, device=dev) for _ in range(3)]
    sfc_codec.reset_launches()
    for i in range(1, 4):
        keys = isfc_key(*c, np.uint64)
        decode_sfc(keys)
        assert sfc_codec.launches() == {"encode": i, "decode": i}
    sfc_codec.reset_launches()
    assert sfc_codec.launches() == {"encode": 0, "decode": 0}


def test_wrapper_raises_rather_than_falling_back(dev):
    c = torch.arange(10, device=dev)
    with pytest.raises(TypeError):
        sfc_codec.encode_grid(c.float(), c, c, 21, 21, torch.int64)
    with pytest.raises(TypeError):
        sfc_codec.encode_grid(c, c.int(), c, 21, 21, torch.int64)
    with pytest.raises(ValueError):
        sfc_codec.encode_grid(c, c.cpu(), c, 21, 21, torch.int64)
    with pytest.raises(TypeError):
        sfc_codec.encode_coords(c.float(), c.double(), c.float(), torch.ones(6, device=dev), np.uint64)
    with pytest.raises(ValueError):
        sfc_codec.encode_coords(c.float(), c.float(), c.float(), torch.ones(6, device=dev, dtype=torch.float64),
                                np.uint64)
    with pytest.raises(ValueError):
        sfc_codec.encode_grid(c, c, c, 10, 11, torch.int64)
