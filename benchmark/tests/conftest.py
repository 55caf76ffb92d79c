"""The benchmark's CPU tests: the `cuda` marker for tests that need the
card (each decides inside itself and skips without one), and a tiny copy
of the benchmark for the drivers' runs."""

import pytest
import torch

from bench_copy import make_copy


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one")
    # the CPU runs are of tiny tensors: threads a worker only contend
    torch.set_num_threads(1)


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_copy(tmp_path_factory.mktemp("bench"))
