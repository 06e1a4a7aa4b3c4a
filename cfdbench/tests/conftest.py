import os

import pytest
import torch

# one thread a test process: pytest-xdist runs several, and the tiny runs
# gain nothing from more
os.environ["OMP_NUM_THREADS"] = "1"


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)
