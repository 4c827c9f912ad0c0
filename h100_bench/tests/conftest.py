"""Tests of the benchmark. Run from the repository's root:

    python -m pytest h100_bench/tests -q

Tests that need an NVIDIA card carry the ``card`` marker and skip without
one; on the card they run in one call. Whether there is a card is decided
inside the ``card`` fixture, never while a module is imported."""
import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card; skipped without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    return "cuda"
