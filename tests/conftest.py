"""Shared fixtures. NOTE: no XLA_FLAGS here — smoke tests and benches
must see the single real CPU device (only dryrun.py requests 512)."""
import jax
import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU with nvcc; skipped without one")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture(scope="session")
def key():
    return jax.random.PRNGKey(0)
