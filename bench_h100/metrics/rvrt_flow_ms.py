"""rvrt_flow_ms: device ms a step of the plain-torch ops credited to the
program's span stnls.rvrt.flow (RVRT's flow composition and its bilinear
warps), forward and backward, in the readers' own traced pass
(bench_h100/spans.py)."""

from bench_h100 import spans


def read(ctx):
    if "cfg" not in ctx and "spans" not in ctx:
        return None     # no run of a cell to trace
    return spans.glue_ms(ctx, "stnls.rvrt.flow")
