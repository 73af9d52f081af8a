"""rvrt_swin_ms: device ms a step of the plain-torch ops (torch_glue_ms's
layer) credited to the program's span stnls.rvrt.swin (RVRT's Swin
layers: window attention and GEGLU MLP, their GEMMs and copies), forward
and backward, in the readers' own traced pass (bench_h100/spans.py)."""

from bench_h100 import spans


def read(ctx):
    if "cfg" not in ctx and "spans" not in ctx:
        return None     # no run of a cell to trace
    return spans.glue_ms(ctx, "stnls.rvrt.swin")
