"""Shared fixtures. NOTE: no XLA_FLAGS here — smoke tests and benches must
see 1 CPU device; only launch/dryrun.py forces 512 placeholder devices."""
import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs CUDA cards; skips without them")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


def assert_allclose(a, b, rtol=2e-4, atol=2e-4, err_msg=""):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32),
                               rtol=rtol, atol=atol, err_msg=err_msg)
