"""PooledPatchSum / WeightedPatchSum: weighted patch sum onto a
ps-upsampled grid (PyTorch port of stnls_tpu/agg/pool.py).

The sum comes from the pool kernel (ops/agg_sp_cuda.nl_pool, B9, with B10
as its backward), whose plain version runs for CPU tensors. Int offsets
only (rounded), like the reference, so it is differentiable in vid and
weights only. `WeightedPatchSum` is the same class under the name the
README documents. The TPU-only knobs (impl, budget, spread, wt_hint) are
accepted and do nothing: the kernel is exact for any offsets.
"""

import torch

from stnls_tpu_torch.utils.config import extract_pairs
from stnls_tpu_torch.ops.agg_sp_cuda import nl_pool
from stnls_tpu_torch.ops.geometry import num_queries
from stnls_tpu_torch.agg.utils import ensure_ndim6, ensure_flow_heads, \
    expand_heads


def pooled_patch_sum(vid, weights, flows, ps=7, stride0=4, pt=1, dilation=1,
                     reflect_bounds=True, use_adj=False, itype="float",
                     impl="auto", budget="auto", spread="auto",
                     wt_hint=None):
    """vid [B,(HD),T,F,H,W]; weights [B,HD,T,nH,nW,K] or [B,HD,Q,K];
    flows [...,K,3] -> out [B,HD,T,F,ps*nH,ps*nW] (ps forced odd)."""
    flows = ensure_flow_heads(flows)
    HD = weights.shape[1]
    vid = expand_heads(ensure_ndim6(vid, HD), HD)
    flows = expand_heads(flows, HD)
    B, HD_, T, F, H, W = vid.shape
    nH, nW = num_queries(H, W, stride0)
    K = flows.shape[-2]
    weights6 = weights.reshape(B, HD_, T, nH, nW, K).contiguous()
    flows7 = flows.reshape(B, HD_, T, nH, nW, K, 3).float().contiguous()
    return nl_pool(vid.contiguous(), weights6, flows7, ps=ps,
                   stride0=stride0, pt=pt, dilation=dilation,
                   reflect_bounds=reflect_bounds, use_adj=use_adj)


class PooledPatchSum(torch.nn.Module):
    """pool = PooledPatchSum(ps, stride0); out = pool(vid, weights,
    flows)."""

    def __init__(self, ps=7, stride0=4, pt=1, dilation=1,
                 reflect_bounds=True, use_adj=False, itype="float",
                 impl="auto", budget="auto", spread="auto", wt_hint=None):
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

    def forward(self, vid, weights, flows):
        return pooled_patch_sum(vid, weights, flows, self.ps, self.stride0,
                                self.pt, self.dilation, self.reflect_bounds,
                                self.use_adj, self.itype)

    def flops(self, nrefs, chnls_per_head, nheads, k):
        return nrefs * chnls_per_head * nheads * k * (self.ps ** 2) * self.pt


WeightedPatchSum = PooledPatchSum


def extract_config(cfg, restrict=True):
    pairs = {"ps": 7, "stride0": 4, "pt": 1, "dilation": 1,
             "reflect_bounds": True, "use_adj": False, "itype": "float"}
    return extract_pairs(cfg, pairs, restrict=restrict)


def init(cfg):
    cfg = extract_config(cfg)
    return PooledPatchSum(cfg.ps, cfg.stride0, cfg.pt, cfg.dilation,
                          cfg.reflect_bounds, cfg.use_adj, cfg.itype)
