"""dinat_na_glue_ms: device ms a step of the plain-torch ops credited to
DiNAT's attention core, the program's span stnls.dinat.na (the split
into heads, the scaled queries, the bias, the softmax, the padding, the
merged heads) and the spans inside it (the search's stnls.search and
stnls.search.volume: its channels-last copies, offsets and the volume's
layout copy; the pool's stnls.agg.pool: its copies), forward and
backward; B5, B6, B9 and B10 are not counted. In the readers' own traced
pass (bench_h100/spans.py)."""

from bench_h100 import spans

INSIDE = ("stnls.search", "stnls.search.volume", "stnls.agg.pool")


def read(ctx):
    if "cfg" not in ctx and "spans" not in ctx:
        return None     # no run of a cell to trace
    na = spans.glue_ms(ctx, "stnls.dinat.na")
    if na is None:
        return None     # a program without the span
    return na + sum(ms for ms in (spans.glue_ms(ctx, s) for s in INSIDE)
                    if ms is not None)
