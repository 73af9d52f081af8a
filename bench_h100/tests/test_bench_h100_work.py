"""work.py's counts are the bring-up's: the bounds chip_smoke.bound_ms
printed for matrix config 6 (B1 2.5069, B2 0.6815, B3 0.3862, B4 0.5348
ms) and config 7 (B1 2.1664, B2 3.3673 ms) on an NVIDIA H100 80GB HBM3."""

import pytest

from bench_h100 import common, work

C6 = dict(B=1, HD=2, T=3, F=8, H=540, W=960)
C7 = dict(B=1, HD=2, T=10, F=2, H=1080, W=1920)
# chip_smoke counted B2's work over the (query, slot) pairs whose
# cotangent was not 0 in its run: 24,391,069 of config 6's 24,883,200
C6_ACTIVE = 24391069


@pytest.mark.parametrize("fn, shape, kw, ms, by", [
    (work.b1_work, C6, dict(ws=5, wt=1, ps=3, K=8), 2.5069, "operations"),
    (work.b2_work, C6, dict(ws=5, wt=1, ps=3, K=8, active=C6_ACTIVE),
     0.6815, "operations"),
    (work.b3_work, C6, dict(ps=3, K=8), 0.3862, "bytes"),
    (work.b4_work, C6, dict(ps=3, K=8), 0.5348, "bytes"),
    (work.b1_work, C7, dict(ws=5, wt=3, ps=1, K=10), 2.1664, "operations"),
    (work.b2_work, C7, dict(ws=5, wt=3, ps=1, K=10), 3.3673, "bytes"),
])
def test_bounds_match_the_bring_up(fn, shape, kw, ms, by):
    got, got_by = work.bound_ms(*fn(**shape, **kw))
    assert round(got, 4) == ms and got_by == by


def test_the_adapters_count_the_configurations_work():
    # at matrix.py config 6's widths, where chip_smoke printed its bounds
    c6 = dict(common.config("denoiser540p"), embed_dim=8, ws=5, K=8, nres=1)
    den = common.adapter("denoiser540p").work(c6, "train")
    assert round(work.bound_ms(*den["B1"])[0], 4) == 2.5069
    assert round(work.bound_ms(*den["B4"])[0], 4) == 0.5348
    # every selected pair counted: 2% above chip_smoke's active count
    assert round(work.bound_ms(*den["B2"])[0], 4) == 0.6952
    assert 2.8e11 < den["step"] < 3.4e11
    infer = common.adapter("denoiser540p").work(
        common.config("denoiser540p"), "infer")
    assert set(infer) == {"B1", "B3", "step"}
    # the configuration's own widths: B1 grows with ws^2 x F
    full = common.adapter("denoiser540p").work(
        common.config("denoiser540p"), "train")
    assert round(work.bound_ms(*full["B1"])[0], 4) == 16.2446
    assert 1.6e12 < full["step"] < 1.8e12
    ali = common.adapter("align1080p").work(common.config("align1080p"),
                                            "train")
    assert round(work.bound_ms(*ali["B1"])[0], 4) == 2.1664
    assert round(work.bound_ms(*ali["B2"])[0], 4) == 3.3673
    assert ali["step"] == ali["B1"][1] + ali["B2"][1]


def test_conv_flops():
    assert work.conv_flops(1, 2, 3, 4, 5, 3) == 2 * 6 * 20 * 9
    f = work.conv_flops(3, 8, 8, 16, 16, 1)
    assert work.conv_step_flops(3, 8, 8, 16, 16, 1, True) == 3 * f
    assert work.conv_step_flops(3, 8, 8, 16, 16, 1, True, False) == 2 * f
    assert work.conv_step_flops(3, 8, 8, 16, 16, 1, False) == f
    assert work.share(1., 0) is None and work.share(1., 4.) == 25.
