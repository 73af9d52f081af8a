"""b9_roofline: B9's (the pooled weighted sum, agg_pool_fwd_row_kernel)
least time by work.py's bound_ms (bytes over 3.35 TB/s or operations
over 67 TFLOP/s, whichever is larger) on the adapter's work()["B9"]
(work_window.py's counts) over its device ms a step in the trace,
found by its device name."""

from bench_h100 import work


def read(ctx):
    return work.kernel_share(ctx, "B9")
