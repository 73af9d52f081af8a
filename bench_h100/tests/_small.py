"""What the CPU tests share: small sizes of each configuration and a run
of a cell on the CPU, the chip check skipped."""

import torch

from bench_h100 import common

BENCH = common.benchmark()
SIZES = {"denoiser540p": dict(H=24, W=32),
         "align1080p": dict(T=5, H=24, W=32)}
CELLS = [w["name"] for w in BENCH["workloads"]]


def size(cell):
    return SIZES[common.workload(cell)["config"]]


def run_small(cell, seed=2 ** 31 + 99):
    """A whole run of `cell` at its small size on the CPU, through the
    port's plain versions: the result line's object."""
    from bench_h100.run import run_cell
    return run_cell(torch, BENCH, cell, seed, 0.05, 0, torch.device("cpu"),
                    size=size(cell))
