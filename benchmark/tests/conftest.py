"""Fixtures of the benchmark's own tests (run with `python -m pytest
benchmark/tests -q` from the root of the checkout; they are not part of
`tests/`). A test that needs the card takes the `card` fixture and
carries the `cuda` marker."""

import pytest


@pytest.fixture
def card():
    """The CUDA device; skips the test where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")
