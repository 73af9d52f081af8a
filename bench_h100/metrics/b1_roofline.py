"""b1_roofline: B1's least time by work.py (bytes over 3.35 TB/s or
operations over 67 TFLOP/s, whichever is larger) over its device ms a
step in the trace, found by its device name."""

from bench_h100 import work


def read(ctx):
    return work.kernel_share(ctx, "B1")
