"""NonLocalScatterAdd: scatter-sum into an output video (PyTorch port of
stnls_tpu/agg/scatter_add.py).

The sum comes from the ScatterAdd kernel (ops/agg_sp_cuda.nl_scatter_add,
B7, with B8 as its backward), whose plain version runs for CPU tensors.
The offsets are rounded (int path, whatever `itype`), so the sum is
differentiable in vid and weights only. The output is left unnormalised,
like the reference; the counts quirk is ops/agg.scatter_add_counts. The
TPU-only knobs (impl, budget, spread, wt_hint) are accepted and do
nothing: the kernel is exact for any offsets.
"""

import torch

from stnls_tpu_torch.utils.config import extract_pairs
from stnls_tpu_torch.ops.agg_sp_cuda import nl_scatter_add
from stnls_tpu_torch.ops.geometry import num_queries
from stnls_tpu_torch.agg.utils import ensure_ndim6, ensure_flow_heads, \
    expand_heads


def non_local_scatter_add(vid, weights, flows, ps=7, strideIn=4, strideOut=4,
                          outH=0, outW=0, pt=1, dilation=1,
                          reflect_bounds=True, use_adj=False, itype="float",
                          impl="auto", budget="auto", spread="auto",
                          wt_hint=None):
    """vid [B,(HD),T,F,H,W]; weights [B,HD,T,nH,nW,K] or [B,HD,Q,K];
    flows [...,K,3] -> out [B,HD,T,F,outH,outW]."""
    flows = ensure_flow_heads(flows)
    HD = weights.shape[1]
    vid = expand_heads(ensure_ndim6(vid, HD), HD)
    flows = expand_heads(flows, HD)
    B, HD_, T, F, H, W = vid.shape
    nH, nW = num_queries(H, W, strideIn)
    K = flows.shape[-2]
    weights6 = weights.reshape(B, HD_, T, nH, nW, K).contiguous()
    flows7 = flows.reshape(B, HD_, T, nH, nW, K, 3).float().contiguous()
    return nl_scatter_add(vid.contiguous(), weights6, flows7, ps=ps,
                          strideIn=strideIn, strideOut=strideOut, pt=pt,
                          dilation=dilation, reflect_bounds=reflect_bounds,
                          use_adj=use_adj, outH=outH, outW=outW)


class NonLocalScatterAdd(torch.nn.Module):
    """scatter = NonLocalScatterAdd(ps, strideIn, strideOut);
    out = scatter(vid, weights, flows)."""

    def __init__(self, ps=7, strideIn=4, strideOut=4, outH=0, outW=0, pt=1,
                 dilation=1, reflect_bounds=True, use_adj=False,
                 itype="float", impl="auto", budget="auto", spread="auto",
                 wt_hint=None):
        super().__init__()
        self.ps = ps
        self.strideIn = strideIn
        self.strideOut = strideOut
        self.outH = outH
        self.outW = outW
        self.pt = pt
        self.dilation = dilation
        self.reflect_bounds = reflect_bounds
        self.use_adj = use_adj
        self.itype = itype
        self.impl = impl
        self.budget = budget
        self.spread = spread
        self.wt_hint = wt_hint

    def forward(self, vid, weights, flows):
        return non_local_scatter_add(
            vid, weights, flows, self.ps, self.strideIn, self.strideOut,
            self.outH, self.outW, self.pt, self.dilation,
            self.reflect_bounds, self.use_adj, self.itype)

    def flops(self, nrefs, chnls_per_head, nheads, k):
        return nrefs * chnls_per_head * nheads * k * (self.ps ** 2) * self.pt


def extract_config(cfg, restrict=True):
    pairs = {"ps": 7, "strideIn": 4, "strideOut": 4, "outH": 0, "outW": 0,
             "pt": 1, "dilation": 1, "reflect_bounds": True,
             "use_adj": False, "itype": "float"}
    return extract_pairs(cfg, pairs, restrict=restrict)


def init(cfg):
    cfg = extract_config(cfg)
    return NonLocalScatterAdd(cfg.ps, cfg.strideIn, cfg.strideOut, cfg.outH,
                              cfg.outW, cfg.pt, cfg.dilation,
                              cfg.reflect_bounds, cfg.use_adj, cfg.itype)
