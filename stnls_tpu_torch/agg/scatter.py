"""NonLocalScatter: scatter query patches to their K non-local locations,
deduplicated into S "neighbourhood slots" by precomputed labels (PyTorch
port of stnls_tpu/agg/scatter.py; the reference's agg/scatter.py and
scatter_int_kernel.cu, int offsets only).

    stack[b,hd,s,t,:,nl_ij] += w[q,k] * vid[b,hd,ref_t,:,ref_ij]
    mask[b,hd,s,t,0,nl_ij] = 1       for the edge (q,k) with label s,

normalised by the query-patch fold counts (reference scatter.py:128-129).
Plain PyTorch, as the JAX module is plain jnp (it has no Pallas kernel):
each patch tap adds into one flat buffer with index_add_ (atomic adds on
the card, so the order of a sum may differ between calls in the last
bits) and marks the mask with index_fill_. Each (b, hd) has its own row
of the buffer, with one sentinel slot past its end that takes the taps
outside the frame. A write whose flat index falls outside its row (a
label outside [0, S), or a frame that one reflection leaves outside
[0, T)) is treated as the JAX module's .at[] treats it: a negative index
counts from the row's end, down to -(N+1), and one at or past the end is
sent to the sentinel and dropped. No write leaves its (b, hd) row.
Differentiable in vid and weights through autograd.
"""

import torch

from stnls_tpu_torch.utils.config import extract_pairs
from stnls_tpu_torch.utils.spans import span
from stnls_tpu_torch.ops.geometry import reflect_bounds as _reflect, \
    in_bounds, num_queries
from stnls_tpu_torch.ops.agg import patch_overlap_counts
from stnls_tpu_torch.agg.utils import ensure_ndim6, ensure_flow_heads, \
    expand_heads


def non_local_scatter(vid, weights, flows_k, labels, ps=7, stride0=4, pt=1,
                      reflect_bounds=True, dilation=1, use_adj=False,
                      itype="int", S=None):
    """vid [B,(HD),T,F,H,W]; weights, labels [B,HD,T,nH,nW,K] or
    [B,HD,Q,K]; flows_k [...,K,3] -> (stack [B,HD,S,T,F,H,W],
    mask [B,HD,S,T,1,H,W]). S defaults to labels.max()+1 (a host sync)."""
    flows_k = ensure_flow_heads(flows_k)
    HD = flows_k.shape[1]
    vid = expand_heads(ensure_ndim6(vid, HD), HD)
    B, HD, T, F, H, W = vid.shape
    K = flows_k.shape[-2]
    nH, nW = num_queries(H, W, stride0)
    dev = vid.device
    patch_offset = 0 if use_adj else -(ps // 2)
    if S is None:
        S = int(labels.max()) + 1
    flows_k = torch.round(flows_k) if flows_k.is_floating_point() \
        else flows_k
    flows_k = flows_k.to(torch.int64).reshape(B, HD, T, nH, nW, K, 3)
    weights = weights.reshape(B, HD, T, nH, nW, K)
    labels = labels.reshape(B, HD, T, nH, nW, K).to(torch.int64)

    t = torch.arange(T, device=dev)[None, None, :, None, None, None]
    h = (torch.arange(nH, device=dev) * stride0)[None, None, None, :, None,
                                                  None]
    w = (torch.arange(nW, device=dev) * stride0)[None, None, None, None, :,
                                                  None]
    nl_t = _reflect(t + flows_k[..., 0], T)
    nl_h = _reflect(h + flows_k[..., 1], H)
    nl_w = _reflect(w + flows_k[..., 2], W)

    # rows of F channels: row (b*HD + hd) * (N + 1) + i of the buffer holds
    # stack element i of (b, hd); i = N is the sentinel
    N = S * T * H * W
    n = T * nH * nW * K
    vid_rf = vid.reshape(B, HD, T, F, H * W).transpose(3, 4) \
        .reshape(B, HD, T * H * W, F)
    bh = torch.arange(B * HD, device=dev).reshape(B, HD, 1, 1, 1, 1)
    stack_rf = vid.new_zeros((B * HD * (N + 1), F))
    mask_flat = vid.new_zeros(B * HD * (N + 1))

    for pk in range(pt):
        rt = _reflect(t + pk, T)
        nt = _reflect(nl_t + pk, T)
        for pi in range(ps):
            dHp = dilation * (pi + patch_offset)
            rh = h + dHp  # ref not reflected (scatter_int.cu:42-43)
            sh = nl_h + dHp
            if reflect_bounds:
                sh = _reflect(sh, H)
            for pj in range(ps):
                dWp = dilation * (pj + patch_offset)
                rw = w + dWp
                sw = nl_w + dWp
                if reflect_bounds:
                    sw = _reflect(sw, W)
                ok = (in_bounds(rh, H) & in_bounds(rw, W)
                      & in_bounds(sh, H) & in_bounds(sw, W))
                ridx = (rt * H + rh.clamp(0, H - 1)) * W + rw.clamp(0, W - 1)
                ridx = ridx.expand(B, HD, T, nH, nW, K).reshape(B, HD, n, 1)
                pix = torch.take_along_dim(vid_rf, ridx, dim=2)
                val = pix * weights.reshape(B, HD, n, 1)
                val = torch.where(ok.reshape(B, HD, n, 1), val, 0.)
                sidx = ((labels * T + nt) * H + sh.clamp(0, H - 1)) * W \
                    + sw.clamp(0, W - 1)
                sidx = torch.where(sidx < 0, sidx + N + 1, sidx)
                keep = ok & (sidx >= 0) & (sidx < N)
                sidx = torch.where(keep, sidx, N) + bh * (N + 1)
                sidx = sidx.reshape(-1)
                stack_rf.index_add_(0, sidx, val.reshape(-1, F))
                mask_flat.index_fill_(0, sidx, 1.)

    stack = stack_rf.reshape(B, HD, N + 1, F)[:, :, :-1] \
        .reshape(B, HD, S, T, H, W, F).permute(0, 1, 2, 3, 6, 4, 5)
    mask = mask_flat.reshape(B, HD, N + 1)[:, :, :-1] \
        .reshape(B, HD, S, T, 1, H, W)
    counts = torch.as_tensor(
        patch_overlap_counts(H, W, ps, stride0, dilation, use_adj),
        dtype=vid.dtype, device=dev)
    return stack / (counts + 1e-10), mask


class NonLocalScatter(torch.nn.Module):
    """scatter = NonLocalScatter(ps, stride0); stack, mask = scatter(vid,
    weights, flows_k, labels)."""

    def __init__(self, ps, stride0, pt=1, dilation=1, reflect_bounds=True,
                 use_adj=False, itype="int", S=None):
        super().__init__()
        if itype != "int":
            raise ValueError("NonLocalScatter: must use an int search")
        self.ps = ps
        self.stride0 = stride0
        self.pt = pt
        self.dilation = dilation
        self.reflect_bounds = reflect_bounds
        self.use_adj = use_adj
        self.itype = itype
        self.S = S

    def forward(self, vid, weights, flows_k, labels):
        with span("stnls.agg.scatter"):
            return non_local_scatter(vid, weights, flows_k, labels, self.ps,
                                     self.stride0, self.pt,
                                     self.reflect_bounds, self.dilation,
                                     self.use_adj, self.itype, S=self.S)


def _apply(vid, weights, flows, labels, ps=1, stride0=1, pt=1,
           reflect_bounds=True, dilation=1, use_adj=False, itype="int"):
    return non_local_scatter(vid, weights, flows, labels, ps, stride0, pt,
                             reflect_bounds, dilation, use_adj, itype)


def extract_config(cfg, restrict=True):
    pairs = {"ps": 3, "ws": -1, "stride0": 1, "pt": 1,
             "reflect_bounds": True, "dilation": 1, "use_adj": False,
             "itype": "int"}
    return extract_pairs(cfg, pairs, restrict=restrict)


def init(cfg):
    cfg = extract_config(cfg, False)
    return NonLocalScatter(cfg.ps, cfg.stride0, cfg.pt, cfg.dilation,
                           cfg.reflect_bounds, cfg.use_adj, cfg.itype)
