"""Fixtures of the benchmark's own tests (``python -m pytest portbench/tests``
from the repository's root).  CPU tests run at tiny sizes; tests marked
``cuda`` need a card and skip without one."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# a 64 x 64 grid (1.6 m pillars), 2,048-4,096 slots a cloud
TINY_MODEL = {"voxel_size": [1.6, 1.6, 6.0], "grid_feature_size": [64, 64]}


@pytest.fixture(scope="session", autouse=True)
def few_threads():
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(min(4, before))
    yield
    torch.set_num_threads(before)


@pytest.fixture
def card():
    """The CUDA card, or a skip."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: run on the card's machine")
    return torch.device("cuda", 0)
