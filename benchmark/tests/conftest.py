"""The benchmark's CPU tests: the `cuda` marker of the repository's tests
and a session copy of the benchmark with tiny cells (bench_helpers)."""

import pytest

from bench_helpers import make_root


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU and nvcc; skips without them")


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("bench"))
