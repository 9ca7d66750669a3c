"""The benchmark's own tests.  ``card`` marks a test that needs an NVIDIA
card: it is collected everywhere and decides inside its fixture, never at
import, whether to skip.  On a machine with the card, from the checkout's
root: ``python3 -m pytest h100_bench/tests -m card``."""

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (runs on the chip)")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: run these tests on the chip")
    return torch.device("cuda")


@pytest.fixture(autouse=True, scope="session")
def few_threads():
    torch.set_num_threads(4)
