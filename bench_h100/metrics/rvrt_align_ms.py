"""rvrt_align_ms: device ms a step of the plain-torch ops credited to the
program's span stnls.rvrt.align (RVRT's alignment: the q, k, v
projections, the pairs' copies, the joint softmax, the sum over K and the
key frames, the projection and MLP), forward and backward; the search
and gather inside it (B1-B4, G1 and their own stnls.search.* and
stnls.agg.gather spans) are not counted, in the readers' own traced pass
(bench_h100/spans.py)."""

from bench_h100 import spans


def read(ctx):
    if "cfg" not in ctx and "spans" not in ctx:
        return None     # no run of a cell to trace
    return spans.glue_ms(ctx, "stnls.rvrt.align")
