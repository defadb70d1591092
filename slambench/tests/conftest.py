"""The benchmark's own tests: ``python3 -m pytest slambench/tests -q`` from
the repository's root. The tests marked `cuda` need the card and skip
without one."""

import os
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
DATA = Path(__file__).resolve().parent / "data"
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _few_threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, int(os.environ.get("SLAMBENCH_TEST_THREADS", "4"))))
    yield
    torch.set_num_threads(n)
