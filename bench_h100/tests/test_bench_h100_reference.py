"""At a small size on the CPU the plain reference agrees with the port's
plain route (the test imports the port; the reference does not), and
the control, the reference one precision lower, fails the limits."""

import pytest
import torch

from bench_h100 import calibrate, common
from _small import CELLS, size


def _limits(cell):
    return common.config(common.workload(cell)["config"])["limits"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_port_agrees_with_the_reference(cell):
    limits = _limits(cell)
    for kind, _, nums in calibrate.readings(
            torch, cell, [5, 6], [], 2, torch.device("cpu"),
            size=size(cell)):
        assert kind == "program"
        assert set(nums) <= set(limits)
        for name, value in nums.items():
            assert value <= limits[name], (name, value, limits[name])


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails(cell):
    limits = _limits(cell)
    for kind, _, nums in calibrate.readings(
            torch, cell, [], [7], 2, torch.device("cpu"), size=size(cell)):
        assert kind == "control"
        assert any(v > limits[k] for k, v in nums.items()), nums
