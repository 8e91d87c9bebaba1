"""The benchmark's tests import ``perfbench`` from the checkout; the
``cuda`` marker and fixture of the repo's card tests."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips with a reason where"
                   " there is none")


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the cell-size control runs only on"
                    " the card")
    return "cuda"
