"""pytest settings of the benchmark's own tests (cardbench/tests)."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped where the host has none")


@pytest.fixture
def card():
    """The CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this host: the test runs on the card only")
    return torch.device("cuda", 0)
