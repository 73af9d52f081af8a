"""NonLocalGather: weighted non-local patch stacking (PyTorch port of
stnls_tpu/agg/gather.py).

The stack comes from the gather kernel (ops/agg_cuda.nl_gather_stack,
B3), whose plain version runs for CPU tensors. It is differentiable in
vid, weights and (float path) flows. The TPU-only knobs (budget, spread,
wt_hint, tile, impl) are accepted and do nothing: the kernel is exact for
any offsets.
"""

import torch

from stnls_tpu_torch.utils.config import extract_pairs
from stnls_tpu_torch.ops.agg_cuda import nl_gather_stack
from stnls_tpu_torch.agg.utils import (
    ensure_ndim6, ensure_flow_heads, expand_heads,
)


def non_local_gather(vid, weights, flows, ps=7, stride0=4, pt=1,
                     reflect_bounds=True, dilation=1, use_adj=False,
                     itype="float", impl="auto", budget="auto",
                     spread="auto", wt_hint=None, tile=None):
    """vid [B,(HD),T,F,H,W]; weights [B,HD,T,nH,nW,K] or [B,HD,Q,K];
    flows [...,K,3] -> stack [B,HD,K,T,F,H,W]."""
    flows = ensure_flow_heads(flows)
    HD = max(weights.shape[1], flows.shape[1])
    vid = expand_heads(ensure_ndim6(vid, HD), HD)
    flows = expand_heads(flows, HD)
    if itype == "int":
        flows = torch.round(flows)
    B, HD_, T, F, H, W = vid.shape
    nH = (H - 1) // stride0 + 1
    nW = (W - 1) // stride0 + 1
    K = flows.shape[-2]
    weights6 = weights.reshape(B, HD_, T, nH, nW, K).contiguous()
    # int offsets (an int search's) are read as floats by the kernel
    flows7 = flows.reshape(B, HD_, T, nH, nW, K, 3).float().contiguous()
    return nl_gather_stack(vid.contiguous(), weights6, flows7, ps=ps,
                           stride0=stride0, pt=pt, dilation=dilation,
                           reflect_bounds=reflect_bounds, use_adj=use_adj,
                           itype=itype)


class NonLocalGather(torch.nn.Module):
    """stacking = NonLocalGather(ps, stride0); stack = stacking(vid, weights,
    flows)."""

    def __init__(self, ps=7, stride0=4, pt=1, dilation=1,
                 reflect_bounds=True, use_adj=False, itype="float",
                 impl="auto", budget="auto", spread="auto", wt_hint=None,
                 tile=None):
        super().__init__()
        self.ps = ps
        self.stride0 = stride0
        self.pt = pt
        self.dilation = dilation
        self.reflect_bounds = reflect_bounds
        self.use_adj = use_adj
        self.itype = itype
        self.impl = impl
        self.budget = budget
        self.spread = spread
        self.wt_hint = wt_hint
        self.tile = tile

    def forward(self, vid, weights, flows):
        return non_local_gather(vid, weights, flows, self.ps, self.stride0,
                                self.pt, self.reflect_bounds, self.dilation,
                                self.use_adj, self.itype)

    def flops(self, nrefs, chnls_per_head, nheads, k):
        return nrefs * chnls_per_head * nheads * k * (self.ps ** 2) * self.pt


def extract_config(cfg, restrict=True):
    pairs = {"ps": 7, "stride0": 4, "pt": 1, "dilation": 1,
             "reflect_bounds": True, "use_adj": False, "itype": "float",
             "impl": "auto", "agg_budget": "auto", "agg_spread": "auto",
             "wt_hint": None}
    return extract_pairs(cfg, pairs, restrict=restrict)


def init(cfg):
    cfg = extract_config(cfg)
    return NonLocalGather(cfg.ps, cfg.stride0, cfg.pt, cfg.dilation,
                          cfg.reflect_bounds, cfg.use_adj, cfg.itype,
                          impl=cfg.impl, budget=cfg.agg_budget,
                          spread=cfg.agg_spread, wt_hint=cfg.wt_hint)
