import os

# Tests must see the real host device count (the dry-run fakes 512 devices in
# its own process only).
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skipped where torch reports "
        "no CUDA device")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def canon_rows(x):
    """Row-set canonical form for set-equality of record tables."""
    x = np.ascontiguousarray(x)
    return x[np.lexsort(x.T[::-1])]
