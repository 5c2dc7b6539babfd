"""The benchmark's CPU tests: ``python -m pytest portbench/tests -q`` from
the root of the repo. A test that needs the card is marked ``gpu`` and
skips itself, in a fixture, where there is none."""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for path in (BENCH, ROOT):
    if path not in sys.path:
        sys.path.insert(0, path)


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda:0"
