"""The benchmark's tests run from the repository root
(`python -m pytest port_bench/tests`) on the CPU; those marked `cuda`
decide inside the test whether a card is there."""
import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
for _p in (os.path.dirname(BENCH), BENCH, HERE):
    if _p not in sys.path:
        sys.path.insert(0, _p)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"


@pytest.fixture(autouse=True)
def _few_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)
