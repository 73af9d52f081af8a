"""step_mfu: the float32 operations the step's algorithm needs (counted
from shapes by work.py) over the untraced window's mean step time at the
H100's 67 TFLOP/s."""

from bench_h100 import work


def read(ctx):
    flops = ctx["work"].get("step")
    if not flops or ctx["mean_step_s"] <= 0:
        return None
    return 100. * flops / (ctx["mean_step_s"] * work.F32_FLOP_S)
