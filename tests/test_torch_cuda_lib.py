"""The registry of the port's hand-written CUDA kernels (ops/cuda_lib.py):
one library a csrc source, every kernel module's launch counts read and
reset through it, and the plain version of every wrapper whose launches
record_launches() replays. Builds and launches nothing, so it runs on the
CPU."""

import pathlib

import pytest

from cstone_tpu_torch.ops import cuda_lib, neighbors_v1, neighbors_v2, stencil

import torch_threads  # noqa: F401  (two intra-op threads per xdist worker)

CSRC = pathlib.Path(cuda_lib.__file__).resolve().parent.parent / "csrc"
LAUNCH_NAMES = {"stencil_counts", "stencil_density", "stencil_cross", "stencil_counts_asym",
                "pairwise_count_runs", "pairwise_list_runs", "pairwise_count", "sfc_encode", "sfc_decode",
                "mark_walk", "octree_layout", "octree_link", "csarray_counts", "csarray_decide", "csarray_emit"}
REPLAYED = {
    "stencil_counts": stencil.stencil_counts_plain,
    "stencil_density": stencil.stencil_density_plain,
    "stencil_cross": stencil.stencil_cross_plain,
    "stencil_counts_asym": stencil.stencil_counts_asym_plain,
    "pairwise_count_runs": neighbors_v2.pairwise_count_runs_plain,
    "pairwise_list_runs": neighbors_v2.pairwise_list_runs_plain,
    "pairwise_count": neighbors_v1.pairwise_count_plain,
}


def test_every_source_has_exactly_one_library():
    names = [lib.source.name for lib in cuda_lib.libraries()]
    assert len(names) == len(set(names))
    assert sorted(names) == sorted(p.name for p in CSRC.glob("*.cu"))
    assert all(lib.source.is_file() for lib in cuda_lib.libraries())


def test_libraries_selects_sources_by_name():
    sel = cuda_lib.libraries("stencil_sym.cu", "neighbors_v2.cu")
    assert [lib.source.name for lib in sel] == ["stencil_sym.cu", "neighbors_v2.cu"]
    assert set(sel) <= set(cuda_lib.libraries())
    with pytest.raises(KeyError):
        cuda_lib.libraries("missing.cu")


def test_all_launches_has_every_wrapper():
    assert set(cuda_lib.all_launches()) == LAUNCH_NAMES


@pytest.mark.parametrize("name", sorted(REPLAYED))
def test_plain_of_every_replayed_wrapper(name):
    assert cuda_lib.plain_of(name) is REPLAYED[name]


@pytest.mark.parametrize("name", ["mark_walk", "sfc_encode", "encode"])
def test_plain_of_an_unreplayed_name_raises(name):
    with pytest.raises(KeyError):
        cuda_lib.plain_of(name)


def test_reset_all_launches_zeroes_every_counter():
    cuda_lib.reset_all_launches()
    try:
        for _, counts in cuda_lib._COUNTS:
            for name in counts.snapshot():
                counts.add(name, 3)
        assert cuda_lib.all_launches() == dict.fromkeys(LAUNCH_NAMES, 3)
        assert stencil.launches()["stencil_cross"] == 3
    finally:
        cuda_lib.reset_all_launches()
    assert cuda_lib.all_launches() == dict.fromkeys(LAUNCH_NAMES, 0)
    assert stencil.launches() == dict.fromkeys(stencil.launches(), 0)
