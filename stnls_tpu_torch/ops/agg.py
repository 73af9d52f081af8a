"""Aggregation core: weighted non-local patch stacking (PyTorch port of
stnls_tpu/ops/agg.py::nl_gather_stack and patch_overlap_counts).

  stack[b,hd,k,t,:,ref_ij] += w[q,k] * vid[b,hd,nl_t,:,nl_ij]

normalised by the patch-overlap counts. The reference-side pixel
coordinates are static affine functions of the query grid, so every
"scatter" to reference locations is a strided-slice add. This is the body
of the plain version of the gather kernel (ops/agg_cuda.py); autograd
through it gives the gather's backward.
"""

import numpy as np
import torch

from stnls_tpu_torch.ops.geometry import reflect_bounds, num_queries
from stnls_tpu_torch.ops.pgather import patch_gather, pad_frames_cf


def _fold_count_1d(L, n, stride, d):
    """Static count of queries covering each position for one patch offset d:
    positions nh*stride + d for nh in [0,n) intersected with [0,L)."""
    c = np.zeros(L, np.float32)
    pos = np.arange(n) * stride + d
    ok = (pos >= 0) & (pos < L)
    c[pos[ok]] += 1
    return c


def patch_overlap_counts(H, W, ps, stride0, dilation=1, use_adj=False):
    """Static [H,W] overlap counts of the query patch fold. Separable."""
    patch_offset = 0 if use_adj else -(ps // 2)
    nH, nW = num_queries(H, W, stride0)
    ch = np.zeros(H, np.float32)
    cw = np.zeros(W, np.float32)
    for p in range(ps):
        d = dilation * (p + patch_offset)
        ch += _fold_count_1d(H, nH, stride0, d)
        cw += _fold_count_1d(W, nW, stride0, d)
    return ch[:, None] * cw[None, :]


def _valid_ref_slices(n, stride, d, L):
    """Query-index range [n0, n1) whose ref position nh*stride + d lies in
    [0, L), plus the matching strided image slice."""
    n0 = max(0, int(np.ceil(-d / stride)))
    n1 = min(n, (L - 1 - d) // stride + 1)
    n1 = max(n0, n1)
    return n0, n1, slice(n0 * stride + d, (n1 - 1) * stride + d + 1, stride)


def _km_centers(flows_km, ref_t, ref_h, ref_w, T, H, W, is_int):
    """Non-local patch centres, K-major: flows_km [B,HD,K,T,nH,nW,3] ->
    (nl_t, nl_h, nl_w) each [B,HD,K,T,nH,nW], reflect-bounded."""
    dt = flows_km[..., 0]
    dh = flows_km[..., 1]
    dw = flows_km[..., 2]
    t = ref_t[None, None, None, :, None, None]
    h = ref_h[None, None, None, None, :, None]
    w = ref_w[None, None, None, None, None, :]
    nl_t = reflect_bounds(t + torch.round(dt).long(), T)
    if is_int:
        nl_h = reflect_bounds(h + dh.long(), H)
        nl_w = reflect_bounds(w + dw.long(), W)
    else:
        nl_h = reflect_bounds(h.to(dh.dtype) + dh, H)
        nl_w = reflect_bounds(w.to(dw.dtype) + dw, W)
    return nl_t, nl_h, nl_w


def _patch_geometry(nl_h, nl_w, ps, dilation, patch_offset, pad, is_int):
    """Integer patch origin (top-left support pixel, padded coords),
    bilinear fractional parts (float path), and the support size S."""
    o_h = nl_h + dilation * patch_offset
    o_w = nl_w + dilation * patch_offset
    if is_int:
        S = dilation * (ps - 1) + 1
        return o_h.long() + pad, o_w.long() + pad, None, None, S
    S = dilation * (ps - 1) + 2
    fi = torch.floor(o_h)
    fj = torch.floor(o_w)
    return fi.long() + pad, fj.long() + pad, o_h - fi, o_w - fj, S


def _patch_pixel(P, pi, pj, dilation, fh, fw, is_int):
    """Read patch pixel (pi, pj) from the gathered support P
    [B,HD,C,S,S,*tail] -> [B,HD,C,*tail]; bilinear in the float path."""
    a, b = pi * dilation, pj * dilation
    if is_int:
        return P[:, :, :, a, b]
    wh = (1. - fh, fh)
    ww = (1. - fw, fw)
    pv = 0.
    for u in (0, 1):
        for v in (0, 1):
            pv = pv + (wh[u] * ww[v])[:, :, None] * P[:, :, :, a + u, b + v]
    return pv


def nl_gather_stack(vid, weights, flows, *, ps, stride0, pt=1, dilation=1,
                    reflect_bounds_=True, use_adj=False, itype="float"):
    """NonLocalGather: weighted non-local patch stack.

    vid [B,HD,T,F,H,W]; weights [B,HD,T,nH,nW,K]; flows [B,HD,T,nH,nW,K,3]
    (relative offsets) -> stack [B,HD,K,T,F,H,W], count-normalised.
    Reads reflect at the frame borders (reflect_bounds_=False is not yet
    ported).
    """
    if not reflect_bounds_:
        raise NotImplementedError(
            "nl_gather_stack with reflect_bounds=False is not yet ported, "
            "see ROADMAP")
    B, HD, T, F, H, W = vid.shape
    K = flows.shape[-2]
    dev = vid.device
    nH, nW = num_queries(H, W, stride0)
    is_int = (itype == "int")
    patch_offset = 0 if use_adj else -(ps // 2)
    if is_int:
        flows = torch.round(flows)
    w_km = weights.reshape(B, HD, T, nH, nW, K).permute(0, 1, 5, 2, 3, 4)
    f_km = flows.reshape(B, HD, T, nH, nW, K, 3).permute(0, 1, 5, 2, 3, 4, 6)

    ref_t = torch.arange(T, device=dev)
    ref_h = torch.arange(nH, device=dev) * stride0
    ref_w = torch.arange(nW, device=dev) * stride0
    nl_t, nl_h, nl_w = _km_centers(f_km, ref_t, ref_h, ref_w, T, H, W,
                                   is_int)

    pad = dilation * (ps - 1) + 2
    if pad > min(H, W) - 1:
        raise ValueError("frame too small for single-fold pad")
    vp, (Tp, Hp, Wp) = pad_frames_cf(vid, pad)
    oi, oj, fh, fw, S = _patch_geometry(
        nl_h, nl_w, ps, dilation, patch_offset, pad, is_int)

    stack = vid.new_zeros((B, HD, F, K, T, H, W))
    for pk in range(pt):
        tj = reflect_bounds(nl_t + pk, T).expand(B, HD, K, T, nH, nW)
        P = patch_gather(vp, (tj, oi, oj), (S, Tp, Hp, Wp))
        for pi in range(ps):
            dHp = dilation * (pi + patch_offset)
            h0, h1, sh = _valid_ref_slices(nH, stride0, dHp, H)
            for pj in range(ps):
                dWp = dilation * (pj + patch_offset)
                w0, w1, sw = _valid_ref_slices(nW, stride0, dWp, W)
                if h0 >= h1 or w0 >= w1:
                    continue
                pv = _patch_pixel(P, pi, pj, dilation, fh, fw, is_int)
                val = pv * w_km[:, :, None]          # [B,HD,F,K,T,nH,nW]
                stack[..., sh, sw] += val[..., h0:h1, w0:w1]
    stack = stack.permute(0, 1, 3, 4, 2, 5, 6)    # [B,HD,K,T,F,H,W]
    counts = torch.as_tensor(
        patch_overlap_counts(H, W, ps, stride0, dilation, use_adj),
        dtype=vid.dtype, device=dev)
    return stack / (counts + 1e-10)
