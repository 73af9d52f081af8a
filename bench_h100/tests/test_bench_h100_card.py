"""On the card: a short run of each cell is correct and prints the
contract's line. Skips without a CUDA device (decided in the fixture)."""

import json
import subprocess
import sys

import pytest

from _small import CELLS
from bench_h100 import common


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_on_the_card(card, cell):
    run = subprocess.run(
        [sys.executable, "bench_h100/run.py", "--workload", cell, "--seed",
         str(2 ** 31 + 5), "--seconds", "2", "--trace", "0"],
        cwd=common.ROOT, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    res = json.loads(run.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    assert res["device"]["platform"] == "gpu"
    assert set(res["metrics"]) == {"frames_per_s", "step_p90_ms",
                                   "peak_mem_gb", "setup_s"}
