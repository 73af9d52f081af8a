"""Shared setup of the port's parity tests: one torch thread (the suite
runs on several workers) and full-float32 matmuls and convolutions. JAX
runs on the CPU (tests/conftest.py). Helpers: torch_port_helpers.py."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@pytest.fixture
def rng():
    return np.random.default_rng(0)
