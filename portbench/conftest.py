"""Settings of the benchmark's own tests (``python -m pytest portbench``).

Tests that need the card carry the ``card`` marker and take the ``card``
fixture, which skips them where there is no CUDA device.
"""
import pytest

def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card; skips where there is none")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return "cuda"


@pytest.fixture
def quiet():
    def log(*args, **kwargs):
        pass
    return log
