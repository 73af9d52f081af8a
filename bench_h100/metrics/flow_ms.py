"""flow_ms: device ms a step of the plain-torch ops (torch_glue_ms's
layer) credited to the program's span stnls.search.flow (search_flow's
walk over the window's frames), forward and backward, in the readers'
own traced pass (bench_h100/spans.py)."""

from bench_h100 import spans


def read(ctx):
    return spans.glue_ms(ctx, "stnls.search.flow")
