"""glue_unspanned_ms: device ms a step of the plain-torch ops
(torch_glue_ms's layer) that no stnls.* span of the program is credited
with, forward or backward: what the spans do not name yet, in the
readers' own traced pass (bench_h100/spans.py). None where the program
opens no stnls.* span."""

from bench_h100 import spans


def read(ctx):
    return spans.glue_ms(ctx, None)
