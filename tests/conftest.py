"""Shared fixtures.  NOTE: no XLA_FLAGS here — smoke tests and benches must
see the host's real (single) device; only launch/dryrun.py forces 512."""
import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips without one")
