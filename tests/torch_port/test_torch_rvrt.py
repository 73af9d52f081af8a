"""RVRT with Shifted-NLS alignment (stnls_tpu_torch/models/rvrt.py)
against its plain reference (bench_h100/reference/rvrt256.py, which
judges the benchmark's runs) at a small size on the CPU, where the search
and gather run their plain versions. The reference is judged at the
port's own selection and search centres, as the benchmark judges it; the
selection is held to the reference's own top-K apart from the outputs.

Tolerances: the port and the reference sum in other orders (the port
stacks the four (query frame, key frame) pairs of an alignment into one
search and sums the gathered values with torch's reductions; the
reference takes one pair at a time) through 36 Swin layers and 8
sequential alignments, so they agree to float32 rounding, not bitwise.
The port's flows compose by grid_sample and average the offsets with
.mean(); the reference reads its four corners and sums in its own
order: they agree to float32 rounding too. Each tolerance is ~10x above
the port's readings here (out 2.4e-7, loss 0, grads 7.5e-7, dists 5.5e-6, prods
2.9e-6, flows 1.2e-6) and below what TF32 operands give
(test_a_tf32_run_fails_the_tolerances).
"""

import pytest
import torch

from stnls_tpu_torch.models.rvrt import Align, SwinLayer
from bench_h100.reference import rvrt256 as reference

from torch_port_helpers import rvrt_case, rvrt_train_step

# out: largest |out - reference's| (|out| ~ 3); loss: relative; grads:
# the worst parameter's error norm over its (or the median) norm; dists:
# the ranked dists against the reference's own top-K; inds: the dists
# against the reference's prods at the port's offsets (|dist| ~ 5);
# flows: pixels (|flow| ~ 4)
TOLS = dict(out_err=3e-6, loss_err=1e-6, grad_err=1e-5, dists_err=1e-4,
            inds_err=1e-4, flow_err=1e-5)
CPU = torch.device("cpu")


def _judged(seed=0, **size):
    cfg, params, clip = rvrt_case(seed, **size)
    run = rvrt_train_step(cfg, params, clip, CPU)
    return reference.judge(clip, run, params, cfg, "train"), run


@pytest.mark.parametrize("seed", [0, 1])
def test_port_matches_the_reference(seed):
    """out, the loss and every parameter's gradient, at the port's
    selection."""
    nums, _ = _judged(seed)
    for name in ("out_err", "loss_err", "grad_err"):
        assert nums[name] <= TOLS[name], (name, nums)


def test_selection_matches_the_reference_top_k():
    """Every alignment's ranked dists against the reference's own top-K
    of the ws x ws prod lattice, and the dists against the reference's
    prods at the port's offsets."""
    nums, run = _judged(2)
    assert nums["dists_err"] <= TOLS["dists_err"], nums
    assert nums["inds_err"] <= TOLS["inds_err"], nums
    d = run["align"][0]["dists"]
    assert d.shape == (1, 2, 2, 2, 8, 8, 4)
    assert (d[..., :-1] >= d[..., 1:]).all()          # descending prods


def test_a_tf32_run_fails_the_tolerances():
    """The reference with TF32 operands and its own selection, put in the
    port's place, fails at least one tolerance: they are tight enough to
    tell a lower precision."""
    cfg, params, clip = rvrt_case(3)
    control = reference.outputs(clip, params, cfg, "train", round_tf32=True)
    nums = reference.judge(clip, control, params, cfg, "train")
    assert any(v > TOLS[k] for k, v in nums.items()), nums


def test_align_calls_once_per_clip_after_the_first_in_each_branch():
    cfg, params, clip = rvrt_case(4)
    before = Align.calls
    run = rvrt_train_step(cfg, params, clip, CPU)
    clips = cfg["T"] // 2
    assert Align.calls - before == 4 * (clips - 1)
    assert len(run["align"]) == 4 * (clips - 1)


@pytest.mark.parametrize("size", [dict(H=40, W=40), dict(H=32, W=48, T=4)])
def test_window_padding_at_features_off_the_window(size):
    """40^2 frames give 10^2 features, padded to whole (2, 4, 4)
    windows; 32x48 gives 8x12 at T 4 (two clips)."""
    nums, _ = _judged(5, **size)
    for name, tol in TOLS.items():
        assert nums[name] <= tol, (name, nums)


@pytest.mark.parametrize("extent,shifted", [
    ((2, 10, 10), True), ((2, 10, 10), False), ((2, 3, 5), True),
    ((1, 6, 9), True)])
def test_swin_layer_pads_clips_and_shifts_as_the_reference(extent,
                                                           shifted):
    """A Swin layer of window (2, 4, 4): padded to whole windows,
    shifted under Swin's mask, and clipped (no shift) along an axis no
    longer than its window."""
    torch.manual_seed(6)
    layer = SwinLayer(16, 2, (2, 4, 4), shifted, 2.)
    with torch.no_grad():
        layer.attn.relative_position_bias_table.uniform_(-0.5, 0.5)
    x = torch.randn((2,) + extent + (16,))
    params = {f"L.{n}": p for n, p in layer.named_parameters()}
    want = reference.swin_layer(reference.Ops(params), x, "L", 2,
                                (2, 4, 4), shifted)
    torch.testing.assert_close(layer(x), want, atol=1e-6, rtol=1e-6)

