"""pytest settings of the benchmark's own tests (``python -m pytest portbench/tests``):
the ``card`` marker of tests that need a CUDA card. Such a test decides
inside itself, through the ``card`` fixture, and skips where there is none."""
import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips where there is none")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
