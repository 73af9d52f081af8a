"""Aggregation cores (PyTorch port of stnls_tpu/ops/agg.py): weighted
non-local patch stacking and summing.

  * nl_gather_stack  (NonLocalGather):
      stack[b,hd,k,t,:,ref_ij] += w[q,k] * vid[b,hd,nl_t,:,nl_ij],
      normalised by the patch-overlap counts;
  * nl_gather_add    (NonLocalGatherAdd): the same summed over K into an
      output video on the strideOut grid;
  * nl_scatter_add   (NonLocalScatterAdd): the transpose,
      out[nl_ij] += w[q,k] * vid[ref_ij], unnormalised, with the
      reference's counts quirk (scatter_add_counts);
  * nl_pool          (PooledPatchSum): K-summed patches on the
      ps-upsampled grid.

The reference-side pixel coordinates are static affine functions of the
query grid, so every "scatter" to reference locations is a strided-slice
add; only nl_scatter_add needs a true scatter (index_add_). These are the
bodies of the kernels' plain versions (ops/agg_cuda.py: B3; ops/
agg_sp_cuda.py: B7, B9); autograd through them gives the backwards (B4,
B8, B10). nl_gather_add has no kernel of its own: it is its own port.
"""

import numpy as np
import torch

from stnls_tpu_torch.ops.geometry import reflect_bounds, in_bounds, \
    num_queries
from stnls_tpu_torch.ops.pgather import patch_gather, pad_frames_cf

# |offset| at or above this marks the search's -1e8 "invalid" fill
FILL_LIMIT = 1e7


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


def _patch_pixel(P, pi, pj, dilation, fh, fw, is_int, masks=None):
    """Read patch pixel (pi, pj) from the gathered support P
    [B,HD,C,S,S,*tail] -> [B,HD,C,*tail]; bilinear in the float path.
    masks: optional (ok, mh0, mh1, mw0, mw1) validity multipliers
    [B,HD,*tail] for reflect_bounds=False (int path: (ok,))."""
    a, b = pi * dilation, pj * dilation
    if is_int:
        pv = P[:, :, :, a, b]
        return pv if masks is None else pv * masks[0][:, :, None]
    wh = (1. - fh, fh)
    ww = (1. - fw, fw)
    if masks is not None:
        ok, mh0, mh1, mw0, mw1 = masks
        wh = (wh[0] * mh0 * ok, wh[1] * mh1 * ok)
        ww = (ww[0] * mw0, ww[1] * mw1)
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
    w_km, f_km = _km_inputs(weights, flows, B, HD, T, nH, nW, K)

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


def default_out_size(inH, inW, nH, nW, strideOut, outH=0, outW=0):
    """Output-size defaulting shared by gather_add and scatter_add."""
    if outH == 0 or outH is None:
        outH = strideOut * nH if strideOut == 1 else inH
    if outW == 0 or outW is None:
        outW = strideOut * nW if strideOut == 1 else inW
    return outH, outW


def _km_inputs(weights, flows, B, HD, T, nH, nW, K):
    """Public trailing-K layout -> K-major views [B,HD,K,T,nH,nW(,3)]."""
    w_km = weights.reshape(B, HD, T, nH, nW, K).permute(0, 1, 5, 2, 3, 4)
    f_km = flows.reshape(B, HD, T, nH, nW, K, 3).permute(0, 1, 5, 2, 3, 4, 6)
    return w_km, f_km


def finite_entries(flows):
    """The (query, slot) entries of offsets [..., 3] that are not the -1e8
    invalid fill."""
    return ((flows[..., 1].abs() < FILL_LIMIT)
            & (flows[..., 2].abs() < FILL_LIMIT))


def nl_gather_add(vid, weights, flows, *, ps, strideIn, strideOut, pt=1,
                  dilation=1, reflect_bounds_=True, use_adj=False,
                  itype="float", outH=0, outW=0):
    """NonLocalGatherAdd: weighted patch sum directly into an output video
    [B,HD,T,F,outH,outW]. Queries read their K non-local patches from the
    strideIn grid of vid and write at the strideOut grid of the output;
    normalised by out-grid overlap counts. Entries with the -1e8 fill are
    dropped; with reflect_bounds_=False, reads outside the frame are 0."""
    B, HD, T, F, H, W = vid.shape
    K = flows.shape[-2]
    dev = vid.device
    nH, nW = num_queries(H, W, strideIn)
    outH, outW = default_out_size(H, W, nH, nW, strideOut, outH, outW)
    is_int = (itype == "int")
    patch_offset = 0 if use_adj else -(ps // 2)
    if is_int:
        flows = torch.round(flows)
    w_km, f_km = _km_inputs(weights, flows, B, HD, T, nH, nW, K)
    w_km = w_km.masked_fill(~finite_entries(f_km), 0.)

    ref_t = torch.arange(T, device=dev)
    in_h = torch.arange(nH, device=dev) * strideIn
    in_w = torch.arange(nW, device=dev) * strideIn
    nl_t, nl_h, nl_w = _km_centers(f_km, ref_t, in_h, in_w, T, H, W, is_int)

    pad = dilation * (ps - 1) + 2
    if pad > min(H, W) - 1:
        raise ValueError("frame too small for single-fold pad")
    vp, (Tp, Hp, Wp) = pad_frames_cf(vid, pad)
    oi, oj, fh, fw, S = _patch_geometry(
        nl_h, nl_w, ps, dilation, patch_offset, pad, is_int)
    o_h = nl_h + dilation * patch_offset
    o_w = nl_w + dilation * patch_offset

    def pixel_masks(pi, pj):
        if reflect_bounds_:
            return None
        a, b = pi * dilation, pj * dilation
        ok = (in_bounds(o_h + a, H) & in_bounds(o_w + b, W)).to(vid.dtype)
        if is_int:
            return (ok,)
        mh = [in_bounds(oi - pad + a + u, H).to(vid.dtype) for u in (0, 1)]
        mw = [in_bounds(oj - pad + b + v, W).to(vid.dtype) for v in (0, 1)]
        return (ok, mh[0], mh[1], mw[0], mw[1])

    out = vid.new_zeros((B, HD, F, T, outH, outW))
    for pk in range(pt):
        tj = reflect_bounds(nl_t + pk, T).expand(B, HD, K, T, nH, nW)
        P = patch_gather(vp, (tj, oi, oj), (S, Tp, Hp, Wp))
        for pi in range(ps):
            dHp = dilation * (pi + patch_offset)
            h0, h1, sh = _valid_ref_slices(nH, strideOut, dHp, outH)
            for pj in range(ps):
                dWp = dilation * (pj + patch_offset)
                w0, w1, sw = _valid_ref_slices(nW, strideOut, dWp, outW)
                if h0 >= h1 or w0 >= w1:
                    continue
                pv = _patch_pixel(P, pi, pj, dilation, fh, fw, is_int,
                                  masks=pixel_masks(pi, pj))
                # sum over K -> [B,HD,F,T,nH,nW]
                val = (pv * w_km[:, :, None]).sum(3)
                out[..., sh, sw] += val[..., h0:h1, w0:w1]
    out = out.permute(0, 1, 3, 2, 4, 5)
    counts = torch.as_tensor(
        patch_overlap_counts(outH, outW, ps, strideOut, dilation, use_adj),
        dtype=vid.dtype, device=dev)
    return out / (counts + 1e-10)


def scatter_add_counts(flows, *, T, nH, nW, H, W, outH, outW, ps, strideIn,
                       strideOut, dilation, use_adj, reflect_bounds_=True,
                       pt=1):
    """The reference's counts quirk of NonLocalScatterAdd: the histogram
    [outH,outW] of the scatter destinations of b=0, hd=0, query frame 0,
    all k (pk = 0 only). Not differentiable; `pt` is unused, as in the
    reference."""
    K = flows.shape[-2]
    dev = flows.device
    f = torch.round(flows.detach().reshape(
        flows.shape[0], flows.shape[1], T, nH, nW, K, 3)[0, 0, 0])
    f = f.permute(2, 0, 1, 3)                               # [K,nH,nW,3]
    finite = finite_entries(f)
    patch_offset = 0 if use_adj else -(ps // 2)
    out_h = (torch.arange(nH, device=dev) * strideOut)[:, None]
    out_w = (torch.arange(nW, device=dev) * strideOut)[None, :]
    in_h = (torch.arange(nH, device=dev) * strideIn)[:, None]
    in_w = (torch.arange(nW, device=dev) * strideIn)[None, :]
    nl_t = reflect_bounds(f[..., 0].long(), T)
    nl_h = reflect_bounds(out_h + f[..., 1].long(), outH)
    nl_w = reflect_bounds(out_w + f[..., 2].long(), outW)
    nt0 = reflect_bounds(nl_t, T) if reflect_bounds_ else nl_t
    tok = in_bounds(nt0, T)
    cnt = torch.zeros(outH * outW + 1, dtype=torch.float32, device=dev)
    for pi in range(ps):
        dHp = dilation * (pi + patch_offset)
        sh = nl_h + dHp
        if reflect_bounds_:
            sh = reflect_bounds(sh, outH)
        for pj in range(ps):
            dWp = dilation * (pj + patch_offset)
            sw = nl_w + dWp
            if reflect_bounds_:
                sw = reflect_bounds(sw, outW)
            ok = (finite & in_bounds(in_h + dHp, H) & in_bounds(in_w + dWp, W)
                  & in_bounds(sh, outH) & in_bounds(sw, outW) & tok)
            cidx = torch.where(ok, sh.clamp(0, outH - 1) * outW
                               + sw.clamp(0, outW - 1), outH * outW)
            cnt.index_add_(0, cidx.reshape(-1),
                           torch.ones(cidx.numel(), device=dev))
    return cnt[:-1].reshape(outH, outW)


def nl_scatter_add(vid, weights, flows, *, ps, strideIn, strideOut, pt=1,
                   dilation=1, reflect_bounds_=True, use_adj=False,
                   itype="float", outH=0, outW=0):
    """NonLocalScatterAdd: the transposed aggregation. Each query patch
    (read on the strideIn grid of vid; taps outside the frame dropped) is
    scattered, weighted, to its K non-local locations on the strideOut grid
    of the output (the centre and then each tap reflected once, the
    destination frame reflected, the read frame not). Offsets are rounded
    half to even, whatever `itype`; entries with the -1e8 fill are
    dropped. Returns (out [B,HD,T,F,outH,outW] unnormalised, counts
    [outH,outW])."""
    B, HD, T, F, H, W = vid.shape
    K = flows.shape[-2]
    dev = vid.device
    nH, nW = num_queries(H, W, strideIn)
    outH, outW = default_out_size(H, W, nH, nW, strideOut, outH, outW)
    patch_offset = 0 if use_adj else -(ps // 2)
    flows = torch.round(flows)
    w_km, f_km = _km_inputs(weights, flows, B, HD, T, nH, nW, K)
    finite = finite_entries(f_km)

    ref_t = torch.arange(T, device=dev)
    out_h = torch.arange(nH, device=dev) * strideOut
    out_w = torch.arange(nW, device=dev) * strideOut
    # scatter destinations: strideOut grid + offsets, always reflected
    nl_t, nl_h, nl_w = _km_centers(f_km, ref_t, out_h, out_w, T, outH, outW,
                                   True)

    # rows-of-F layout: one gather/scatter moves a whole F-vector per edge
    vid_rf = vid.reshape(B, HD, T, F, H * W).transpose(3, 4) \
        .reshape(B * HD * T * H * W, F)
    dump = B * HD * T * outH * outW
    out_rf = vid.new_zeros((dump + 1, F))
    bh = torch.arange(B * HD, device=dev).reshape(B, HD, 1, 1, 1, 1)
    t_g = ref_t[None, None, None, :, None, None]
    h_g = (torch.arange(nH, device=dev) * strideIn)[:, None]
    w_g = (torch.arange(nW, device=dev) * strideIn)[None, :]
    w_flat = w_km.reshape(-1, 1)
    for pk in range(pt):
        rt = t_g + pk            # the read frame is not reflected
        nt = reflect_bounds(nl_t + pk, T) if reflect_bounds_ else nl_t + pk
        tok = in_bounds(rt, T) & in_bounds(nt, T)
        for pi in range(ps):
            dHp = dilation * (pi + patch_offset)
            rh = h_g + dHp
            sh = nl_h + dHp
            if reflect_bounds_:
                sh = reflect_bounds(sh, outH)
            for pj in range(ps):
                dWp = dilation * (pj + patch_offset)
                rw = w_g + dWp
                sw = nl_w + dWp
                if reflect_bounds_:
                    sw = reflect_bounds(sw, outW)
                ok = (finite & in_bounds(rh, H) & in_bounds(rw, W)
                      & in_bounds(sh, outH) & in_bounds(sw, outW) & tok)
                ridx = ((bh * T + rt.clamp(0, T - 1)) * H
                        + rh.clamp(0, H - 1)) * W + rw.clamp(0, W - 1)
                sidx = ((bh * T + nt.clamp(0, T - 1)) * outH
                        + sh.clamp(0, outH - 1)) * outW \
                    + sw.clamp(0, outW - 1)
                sidx = torch.where(ok, sidx, dump).reshape(-1)
                pix = vid_rf[ridx.expand(ok.shape).reshape(-1)]
                okf = ok.reshape(-1, 1)
                out_rf.index_add_(0, sidx,
                                  torch.where(okf, pix * w_flat, 0.))
    out = out_rf[:-1].reshape(B, HD, T, outH, outW, F) \
        .permute(0, 1, 2, 5, 3, 4)
    counts = scatter_add_counts(
        flows, T=T, nH=nH, nW=nW, H=H, W=W, outH=outH, outW=outW, ps=ps,
        strideIn=strideIn, strideOut=strideOut, dilation=dilation,
        use_adj=use_adj, reflect_bounds_=reflect_bounds_, pt=pt)
    return out, counts.to(vid.dtype)


def nl_pool(vid, weights, flows, *, ps, stride0, pt=1, dilation=1,
            reflect_bounds_=True, use_adj=False):
    """PooledPatchSum: K-summed weighted patches onto a ps-upsampled grid
    [B,HD,T,F,ps*nH,ps*nW]. Int offsets (rounded half to even); ps is
    forced odd, and tap (pi, pj) of query q is written at
    q*ps + psHalf + (pi, pj) + patch_offset, psHalf = (ps-1)//2 + 1, so
    the last tap row and column fall off the grid and the first row and
    column are never written. Reads: the centre, then each tap, reflected
    once. Weights below 1e-8 (negative ones too) are zeroed, and so are
    entries with the -1e8 fill (the reference's engine turns a fill of
    the frame offset into NaN; its TPU route zeroes it like this)."""
    B, HD, T, F, H, W = vid.shape
    K = flows.shape[-2]
    dev = vid.device
    nH, nW = num_queries(H, W, stride0)
    ps = ps + (1 - ps % 2)
    psHalf = (ps - 1) // 2 + 1
    outH, outW = ps * nH, ps * nW
    patch_offset = 0 if use_adj else -(ps // 2)
    flows = torch.round(flows)
    w_km, f_km = _km_inputs(weights, flows, B, HD, T, nH, nW, K)
    w_km = w_km.masked_fill((w_km < 1e-8) | ~finite_entries(f_km), 0.)

    ref_t = torch.arange(T, device=dev)
    in_h = torch.arange(nH, device=dev) * stride0
    in_w = torch.arange(nW, device=dev) * stride0
    nl_t, nl_h, nl_w = _km_centers(f_km, ref_t, in_h, in_w, T, H, W, True)

    vid_rf = vid.reshape(B, HD, T, F, H * W).transpose(3, 4) \
        .reshape(B * HD * T * H * W, F)
    bh = torch.arange(B * HD, device=dev).reshape(B, HD, 1, 1, 1, 1)
    out = vid.new_zeros((B, HD, T, F, outH, outW))
    counts = np.zeros((outH, outW), np.float32)
    for pk in range(pt):
        nt = reflect_bounds(nl_t + pk, T)
        tok = in_bounds(nt, T)
        for pi in range(ps):
            dOut_h = psHalf + pi + patch_offset
            h0, h1, sh = _valid_ref_slices(nH, ps, dOut_h, outH)
            ph = nl_h + dilation * (pi + patch_offset)
            if reflect_bounds_:
                ph = reflect_bounds(ph, H)
            for pj in range(ps):
                dOut_w = psHalf + pj + patch_offset
                w0, w1, sw = _valid_ref_slices(nW, ps, dOut_w, outW)
                if h0 >= h1 or w0 >= w1:
                    continue
                pw = nl_w + dilation * (pj + patch_offset)
                if reflect_bounds_:
                    pw = reflect_bounds(pw, W)
                ok = in_bounds(ph, H) & in_bounds(pw, W) & tok
                gi = ((bh * T + nt.clamp(0, T - 1)) * H
                      + ph.clamp(0, H - 1)) * W + pw.clamp(0, W - 1)
                pix = vid_rf[gi.reshape(-1)].reshape(B, HD, K, T, nH, nW, F)
                coef = torch.where(ok, w_km, 0.)
                # weighted sum over K -> [B,HD,T,F,nH,nW]
                val = (pix * coef[..., None]).sum(2).movedim(-1, 3)
                out[..., sh, sw] += val[..., h0:h1, w0:w1]
                if pk == 0:
                    counts[sh, sw] += 1
    return out / (torch.as_tensor(counts, device=dev) + 1e-10)
