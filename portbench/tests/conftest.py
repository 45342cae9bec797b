"""The benchmark's tests: ``python -m pytest portbench/tests`` from the
root of the repository (the CPU ones), and on a CUDA card
``python -m pytest -m cuda portbench/tests``."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def cuda_card():
    """Skips a test on a machine without a CUDA card."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
