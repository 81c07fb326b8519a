"""pytest settings of the benchmark's own tests (python -m pytest benchmark/tests).

Tests marked `card` need a CUDA card and skip without one; whether there is
one is decided inside the `card` fixture, never while a module is imported.
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
