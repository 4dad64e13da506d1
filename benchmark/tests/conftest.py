"""The benchmark's own tests: the frozen arithmetic, BENCHMARK.json's form, and each
cell at a tiny size on the CPU against its plain reference, with its control and its
faults. ``pytest benchmark/tests``; on the card, ``pytest -m gpu benchmark/tests``."""

import os
import sys

import pytest

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if CHECKOUT not in sys.path:
    sys.path.insert(0, CHECKOUT)


@pytest.fixture(autouse=True)
def one_thread():
    """Tiny CPU runs are slower with many intra-op threads on a shared machine."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
