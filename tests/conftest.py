# NOTE: no XLA_FLAGS here on purpose — smoke tests and benches must see the
# host's real device count (1 CPU device); only launch/dryrun.py forces 512.
import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA CUDA card (runs the port's CUDA "
        "kernels); skipped where none is available")
