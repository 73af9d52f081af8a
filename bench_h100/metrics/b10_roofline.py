"""b10_roofline: B10's (the pooled sum's backward, agg_pool_bwd_kernel)
least time by work.py's bound_ms (bytes over 3.35 TB/s or operations
over 67 TFLOP/s, whichever is larger) on the adapter's work()["B10"]
(work_window.py's counts) over its device ms a step in the trace,
found by its device name."""

from bench_h100 import work


def read(ctx):
    return work.kernel_share(ctx, "B10")
