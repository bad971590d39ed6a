"""pytest settings of the benchmark's own tests (benchmark/tests/).

`card`: a test that needs a CUDA card. Whether there is one is decided
inside the `card` fixture, never while a module is imported; without a
card such a test skips with the reason. On the card:
`python3 -m pytest benchmark/tests -m card`.
"""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; this machine has none")
    return torch.device("cuda", 0)
