"""geometry_ms: device ms a step of the plain-torch ops (torch_glue_ms's
layer) credited to the program's span stnls.search.geometry (the lazy
route's cells_geometry, its offsets and the anchored slot 0), forward
and backward, in the readers' own traced pass (bench_h100/spans.py)."""

from bench_h100 import spans


def read(ctx):
    return spans.glue_ms(ctx, "stnls.search.geometry")
