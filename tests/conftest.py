"""Shared fixtures.  NOTE: no XLA device-count flags here -- smoke tests
must see the real single CPU device; multi-device tests spawn subprocesses
with their own XLA_FLAGS (see test_multidevice.py / test_dryrun_integration).
"""
import numpy as np
import pytest

import jax

# Property tests use hypothesis; the pinned container has no wheel for it.
# Install the in-repo fallback runner iff the real package is missing.
from repro._compat import hypothesis_fallback

hypothesis_fallback.install()


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture(scope="session")
def key():
    return jax.random.PRNGKey(0)


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running integration test")
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips without one")
