"""Shared fixtures of the benchmark's own tests (run with
``python -m pytest portbench/tests -q`` from the repo root; ``tests/``'s
conftest, which imports JAX, is not on this path)."""

import pytest


@pytest.fixture
def card():
    """The CUDA card, or a skip where none is visible (decided here, at
    run time, never while a module is imported)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)
