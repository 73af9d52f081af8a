"""Public flow-composition API (PyTorch port of stnls_tpu/nn/flow.py)."""

from stnls_tpu_torch.ops import flow_ops


def search_flow(fflow, bflow, wt, stride0=1):
    """flows = stnls_tpu_torch.nn.search_flow(fflow, bflow, wt, stride0):
    [B,T,2,H,W] x2 -> [B,T,W_t-1,2,nH,nW]; differentiable."""
    return flow_ops.search_flow(fflow, bflow, max(wt, 0), stride0)


def accumulate_flow(fflow, bflow, stride0=1, fwd_mode="stnls"):
    raise NotImplementedError(
        "accumulate_flow is not yet ported, see ROADMAP")
