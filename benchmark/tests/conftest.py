"""Tests of the benchmark's harness.  CPU tests run the cells at a small
size on the CPU; tests marked `cuda` need the card and skip without one:

    python3 -m pytest benchmark/tests -q            # from the repository root
    python3 -m pytest benchmark/tests -q -m cuda    # on a machine with the card
"""

import pathlib
import sys

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

# small worlds for CPU runs of each configuration, with the expected answers
# made for them (`expected/make_expected.py --size 240 320 --n-frames 6`)
SMALL = {
    "tum_fr3": {"size": [240, 320], "n_frames": 6, "expected": "tum_fr3_w0_240x320"},
}


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _few_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)
