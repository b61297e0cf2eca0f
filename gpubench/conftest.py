"""pytest settings of the benchmark's own tests (``python -m pytest
gpubench/tests``): the ``cuda`` marker, and the fixture that skips a test
where there is no CUDA card (decided when the test runs, never at import)."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card (skipped without one)")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; this machine has none")
    return "cuda"
