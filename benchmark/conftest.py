"""pytest settings of the benchmark's own tests (``benchmark/tests``).

    python -m pytest benchmark/tests -q            # the CPU tests
    python3 -m pytest benchmark/tests -q -m card   # on the card

Tests that need the card carry the ``card`` marker and take the ``card``
fixture, which skips them where no CUDA device is found: decided inside
the fixture, never at import.
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA device (the H100)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    return torch.device("cuda", 0)
