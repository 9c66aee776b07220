import numpy as np
import pytest

# NOTE: no XLA_FLAGS here — tests must see exactly ONE device (the brief);
# multi-device behaviour is tested via subprocesses (tests/subproc/).


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running integration test")
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (skips without one)")
