"""Public flow-composition API (PyTorch port of stnls_tpu/nn/flow.py)."""

from stnls_tpu_torch.ops import flow_ops
from stnls_tpu_torch.ops.flow_ops import (  # noqa: F401
    extract_search_from_accumulated, index_grid,
)
from stnls_tpu_torch.utils.config import ConfigDict


def search_flow(fflow, bflow, wt, stride0=1):
    """flows = stnls_tpu_torch.nn.search_flow(fflow, bflow, wt, stride0):
    [B,T,2,H,W] x2 -> [B,T,W_t-1,2,nH,nW]; differentiable."""
    return flow_ops.search_flow(fflow, bflow, max(wt, 0), stride0)


def accumulate_flow(fflow, bflow, stride0=1, fwd_mode="stnls"):
    """All-pairs accumulated flows: a ConfigDict with .fflow/.bflow
    [B,T,T-1,2,nH,nW]; differentiable. The reference's two fwd modes
    compute the same composition: one walk serves both."""
    del fwd_mode
    pf, pb = flow_ops.accumulate_flow(fflow, bflow, stride0)
    return ConfigDict(fflow=pf, bflow=pb)


def run_accumulate_flow(fflow, bflow, stride0=1):
    """The reference's pure-pytorch path, with the same semantics."""
    return accumulate_flow(fflow, bflow, stride0)
