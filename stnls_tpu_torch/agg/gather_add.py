"""NonLocalGatherAdd: weighted patch sum into an output video (PyTorch
port of stnls_tpu/agg/gather_add.py).

Two routes, chosen from the configuration before any launch, as the JAX
module's `_pallas_ok` chooses (without its budget terms: the port has no
budgets). Where the op is a K-summed NonLocalGather (strideIn ==
strideOut, a stride that divides the frame, the default output size,
pt == 1, reflect_bounds) it is the K-sum of the gather stack
(ops/agg_cuda.nl_gather_stack: B3, with B4 as its backward), under the
same overlap-count normalisation. Elsewhere it is the engine
ops/agg.nl_gather_add, which has no kernel in the JAX package either:
plain torch is its port. The TPU-only knobs (impl, budget, spread,
wt_hint) are accepted and do nothing.
"""

import torch

from stnls_tpu_torch.utils.config import extract_pairs
from stnls_tpu_torch.ops.agg import nl_gather_add, finite_entries
from stnls_tpu_torch.ops.agg_cuda import nl_gather_stack
from stnls_tpu_torch.ops.geometry import num_queries
from stnls_tpu_torch.agg.utils import ensure_ndim6, ensure_flow_heads, \
    expand_heads


def gather_route(ps, strideIn, strideOut, outH, outW, pt, reflect_bounds, H,
                 W):
    """Whether the configuration runs as the K-sum of the gather stack
    (B3/B4); else the engine."""
    nH, nW = num_queries(H, W, strideIn)
    return (strideIn == strideOut and strideIn * nH == H
            and strideIn * nW == W and outH in (0, H) and outW in (0, W)
            and pt == 1 and reflect_bounds)


def non_local_gather_add(vid, weights, flows, ps=7, strideIn=4, strideOut=4,
                         outH=0, outW=0, pt=1, dilation=1,
                         reflect_bounds=True, use_adj=False, itype="float",
                         impl="auto", budget="auto", spread="auto",
                         wt_hint=None):
    """vid [B,(HD),T,F,H,W]; weights [B,HD,T,nH,nW,K] or [B,HD,Q,K];
    flows [...,K,3] -> out [B,HD,T,F,outH,outW], count-normalised."""
    flows = ensure_flow_heads(flows)
    HD = weights.shape[1]
    vid = expand_heads(ensure_ndim6(vid, HD), HD)
    flows = expand_heads(flows, HD)
    B, HD_, T, F, H, W = vid.shape
    if not gather_route(ps, strideIn, strideOut, outH, outW, pt,
                        reflect_bounds, H, W):
        return nl_gather_add(
            vid, weights, flows, ps=ps, strideIn=strideIn,
            strideOut=strideOut, pt=pt, dilation=dilation,
            reflect_bounds_=reflect_bounds, use_adj=use_adj, itype=itype,
            outH=outH, outW=outW)
    nH, nW = num_queries(H, W, strideIn)
    K = flows.shape[-2]
    weights6 = weights.reshape(B, HD_, T, nH, nW, K)
    flows7 = flows.reshape(B, HD_, T, nH, nW, K, 3).float()
    # the -1e8 "invalid" fill entries are dropped: zero their weights and
    # offsets before the kernel, so its reflections never see them
    finite = finite_entries(flows7)
    weights6 = weights6.masked_fill(~finite, 0.).contiguous()
    flows7 = flows7.masked_fill(~finite[..., None], 0.)
    stack = nl_gather_stack(vid.contiguous(), weights6, flows7.contiguous(),
                            ps=ps, stride0=strideIn, pt=pt, dilation=dilation,
                            reflect_bounds=reflect_bounds, use_adj=use_adj,
                            itype=itype)
    return stack.sum(2)


class NonLocalGatherAdd(torch.nn.Module):
    """gather_add = NonLocalGatherAdd(ps, strideIn, strideOut);
    out = gather_add(vid, weights, flows)."""

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
        return non_local_gather_add(
            vid, weights, flows, self.ps, self.strideIn, self.strideOut,
            self.outH, self.outW, self.pt, self.dilation,
            self.reflect_bounds, self.use_adj, self.itype)

    def flops(self, nrefs, chnls_per_head, nheads, k):
        return nrefs * chnls_per_head * nheads * k * (self.ps ** 2) * self.pt


def extract_config(cfg, restrict=True):
    pairs = {"ps": 7, "strideIn": 4, "strideOut": 4, "outH": 0, "outW": 0,
             "pt": 1, "dilation": 1, "reflect_bounds": True,
             "use_adj": False, "itype": "float", "impl": "auto",
             "agg_budget": "auto", "agg_spread": "auto"}
    return extract_pairs(cfg, pairs, restrict=restrict)


def init(cfg):
    cfg = extract_config(cfg)
    return NonLocalGatherAdd(cfg.ps, cfg.strideIn, cfg.strideOut, cfg.outH,
                             cfg.outW, cfg.pt, cfg.dilation,
                             cfg.reflect_bounds, cfg.use_adj, cfg.itype,
                             cfg.impl, cfg.agg_budget, cfg.agg_spread)
