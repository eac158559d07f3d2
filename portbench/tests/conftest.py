"""The benchmark's own tests: on the CPU at small sizes; those marked
`cuda` need a card and skip without one.  Run from the repository root:

    python -m pytest portbench/tests -q -p no:cacheprovider

and on the card `python -m pytest portbench/tests -m cuda`."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU; skips where torch.cuda.is_available() is false",
    )


@pytest.fixture
def card():
    """The first CUDA card; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
