"""rvrt_step_mfu: the float32 operations of the RVRT step (the adapter's
work()["step"]: the linear layers, the attention matmuls and the convs,
three times in train mode, plus B1-B4's own, counted from shapes) over
the untraced window's mean step time at the H100's 67 TFLOP/s, as
step_mfu reads it."""

from bench_h100 import work


def read(ctx):
    flops = ctx["work"].get("step")
    if not flops or ctx["mean_step_s"] <= 0:
        return None
    return 100. * flops / (ctx["mean_step_s"] * work.F32_FLOP_S)
