"""Exhaustive non-local search volume (PyTorch port of stnls_tpu/ops/nls.py).

`lattice_search` lays a ws x ws lattice with spacing stride1 (possibly
fractional) around each per-(query, window slot) centre, shifted in-frame
when full_ws=True, and accumulates patchwise distances (prod or l2) over
(ps, ps, F) with reflected patch reads and, in the float path, bilinear
reads of vid1. `volume_at_centres` runs it over the W_t temporal window
slots at given centres: the plain version of the volume kernel B5, and
its autograd that of B6 (ops/nls_vol_cuda.py); with the top-K rule it is
the plain version of the search kernel B1 (ops/nls_cuda.py).
`nls_search_volume` feeds it the flow-shifted centres of the slots
(`search_centres`).

Only what the search's main path runs is ported: pt=1, no query offsets
(off_Hq/off_Wq), no ws_interior and no refine/time-sharded volumes.
"""

import numpy as np
import torch

from stnls_tpu_torch.ops.geometry import (
    reflect_bounds, in_bounds, num_queries, time_window_frames,
    search_offsets,
)

# dist_type menu
DIST_PROD = 0
DIST_L2 = 1


def dist_type_select(dist_type):
    menu = {"prod": DIST_PROD, "l2": DIST_L2}
    descending = {"prod": True, "l2": False}
    init_val = {"prod": -np.inf, "l2": np.inf}
    return menu[dist_type], descending[dist_type], init_val[dist_type]


def _expand_flow_heads(flows, HD):
    """flows [B,HDf,...] -> per-head view via ihead % HDf."""
    HDf = flows.shape[1]
    if HDf == HD:
        return flows
    reps = torch.tensor([h % HDf for h in range(HD)], device=flows.device)
    return flows[:, reps]


def _slot_flows(flows, W_t):
    """flows [B,HD,T,W_t(-1),2,nH,nW] -> (fH, fW) [B,HD,T,W_t,nH,nW] float,
    with the reference frame's zero slot prepended when missing."""
    st_offset = W_t - flows.shape[3]
    if st_offset not in (0, 1):
        raise ValueError("flows must cover W_t or W_t-1 slots")
    fH = flows[:, :, :, :, 1].float()
    fW = flows[:, :, :, :, 0].float()
    if st_offset == 1:
        zero = fH.new_zeros(fH.shape[:3] + (1,) + fH.shape[4:])
        fH = torch.cat([zero, fH], dim=3)
        fW = torch.cat([zero, fW], dim=3)
    return fH, fW


def _sum_channels(x):
    """Sum over the last (channel) axis in order, one rounded add at a
    time: the order the search kernels sum in (csrc/nls_common.cuh), so
    that their distances and these agree bitwise."""
    s = x[..., 0]
    for f in range(1, x.shape[-1]):
        s = s + x[..., f]
    return s


def _rows(vid):
    """[B,HD,T,F,H,W] -> rows of F channels [(B*HD*T*H*W), F]."""
    B, HD, T, F, H, W = vid.shape
    return vid.permute(0, 1, 2, 4, 5, 3).reshape(B * HD * T * H * W, F)


def lattice_search(vid0, vid1, ctr_t, ctr_h, ctr_w, *, ws, stride1,
                   ref_h, ref_w, dist_type, ps, dilation=1, patch_offset=0,
                   reflect_bounds_=True, full_ws=True, is_int=False):
    """Shared search engine.

    ctr_t: int frame index per (b,hd,t,g,[nh,nw]), broadcastable to
    [B,HD,T,G,nH,nW]; ctr_h/ctr_w: reflected centre coordinates of that
    broadcast shape (int in the int path, float otherwise). ref_h/ref_w:
    [nH]/[nW] int query pixel grids.

    Returns dists [B,HD,T,G,ws,ws,nH,nW]. The offsets of the cells are
    separable and come from ops.nls_k.search_aux.
    """
    B, HD, T, F, qH, qW = vid0.shape
    kH, kW = vid1.shape[-2:]
    nH, nW = ref_h.shape[0], ref_w.shape[0]
    G = ctr_h.shape[3]
    dev = vid0.device
    cdtype = torch.int32 if is_int else vid0.dtype
    t_ids = torch.arange(T, device=dev)

    off_h, off_w = search_offsets(ctr_h, ctr_w, stride1, ws, kH, kW,
                                  full_ws, is_int)
    cells = torch.arange(ws, device=dev, dtype=cdtype)
    # lattice positions [B,HD,T,G,ws,nH,nW]
    prop_h = ctr_h[..., None, :, :] + stride1 * (cells[:, None, None]
                                                 - off_h[..., None, :, :])
    prop_w = ctr_w[..., None, :, :] + stride1 * (cells[:, None, None]
                                                 - off_w[..., None, :, :])
    valid_patch = (in_bounds(prop_h, kH)[..., :, None, :, :]
                   & in_bounds(prop_w, kW)[..., None, :, :, :])

    cell_shape = (B, HD, T, G, ws, ws, nH, nW)
    v0_rows = _rows(vid0)
    v1_rows = _rows(vid1)
    bh = (torch.arange(B, device=dev)[:, None] * HD
          + torch.arange(HD, device=dev)[None, :]).reshape(B, HD, 1, 1, 1,
                                                          1, 1, 1)
    ctr_t8 = ctr_t.long()[..., None, None, :, :]

    acc = torch.zeros(cell_shape, dtype=vid0.dtype, device=dev)
    for pi in range(ps):
        dH = dilation * (pi + patch_offset)
        rh = ref_h + dH
        ph = prop_h[..., :, None, :, :] + dH
        if reflect_bounds_:
            rh = reflect_bounds(rh, qH)
            ph = reflect_bounds(ph, kH)
        for pj in range(ps):
            dW = dilation * (pj + patch_offset)
            rw = ref_w + dW
            pw = prop_w[..., None, :, :, :] + dW
            if reflect_bounds_:
                rw = reflect_bounds(rw, qW)
                pw = reflect_bounds(pw, kW)
            # reference pixel (always an integer read)
            v_ref = in_bounds(rh, qH)[:, None] & in_bounds(rw, qW)[None, :]
            ridx = ((bh.reshape(B, HD, 1, 1, 1) * T
                     + t_ids[None, None, :, None, None]) * qH
                    + rh.clamp(0, qH - 1)[:, None]) * qW \
                + rw.clamp(0, qW - 1)[None, :]          # [B,HD,T,nH,nW]
            p0 = v0_rows[ridx][:, :, :, None, None, None]  # [..,1,1,1,nH,nW,F]
            v_prop = in_bounds(ph, kH) & in_bounds(pw, kW)
            fbase = (bh * T + ctr_t8) * kH
            if is_int:
                idx = (fbase + ph.clamp(0, kH - 1).long()) * kW \
                    + pw.clamp(0, kW - 1).long()
                p1 = v1_rows[idx]
            else:
                h0 = torch.floor(ph)
                w0 = torch.floor(pw)
                p1 = 0.
                for di in (0, 1):
                    for dj in (0, 1):
                        hc = h0 + di
                        wc = w0 + dj
                        wgt = (torch.clamp(1. - torch.abs(hc - ph), min=0.)
                               * torch.clamp(1. - torch.abs(wc - pw), min=0.))
                        wgt = torch.where(in_bounds(hc, kH) & in_bounds(wc, kW),
                                          wgt, torch.zeros_like(wgt))
                        ci = (fbase + hc.clamp(0, kH - 1).long()) * kW \
                            + wc.clamp(0, kW - 1).long()
                        p1 = p1 + wgt[..., None] * v1_rows[ci]
            pair_ok = v_prop & v_ref
            if dist_type == "prod":
                contrib = _sum_channels(p0 * p1)
            else:
                diff = p0 - p1
                contrib = _sum_channels(diff * diff)
            acc = acc + torch.where(pair_ok, contrib,
                                    torch.zeros_like(contrib))

    _, _, init_val = dist_type_select(dist_type)
    return torch.where(valid_patch, acc, torch.full_like(acc, init_val))


def search_centres(vid_shape, flows, *, wt, stride0, itype="float"):
    """Reflected search centres of the W_t window slots: the query grid
    shifted by the flows. vid_shape (B,HD,T,F,H,W); flows
    [B,HDf,T,W_t or W_t-1,2,nH,nW] (channel 0 = w, 1 = h; the reference
    frame's slot is prepended with zero flow when missing). Returns
    (ctr_h, ctr_w) float [B,HD,T,W_t,nH,nW], differentiable in the flows
    (the reflection's sign included); integers in the int path, whose
    flows are rounded."""
    B, HD, T, F, H, W = vid_shape
    dev = flows.device
    nH, nW = num_queries(H, W, stride0)
    flows = _expand_flow_heads(flows, HD)
    if itype == "int":
        flows = torch.round(flows)
    fH, fW = _slot_flows(flows, min(2 * wt + 1, T))
    ref_h = (torch.arange(nH, device=dev) * stride0) % H
    ref_w = (torch.arange(nW, device=dev) * stride0) % W
    ctr_h = reflect_bounds(ref_h[:, None].float() + fH, H)
    ctr_w = reflect_bounds(ref_w[None, :].float() + fW, W)
    return ctr_h, ctr_w


def volume_at_centres(vid0, vid1, ctr_h, ctr_w, *, ws, wt, ps, stride0,
                      stride1, dist_type="l2", dilation=1,
                      reflect_bounds_=True, full_ws=True, use_adj=False,
                      itype="float"):
    """The search volume at given reflected centres: `lattice_search` over
    the W_t window frames. vid0/vid1 [B,HD,T,F,H,W]; ctr_h, ctr_w
    [B,HD,T,W_t,nH,nW] (`search_centres`). Returns dists
    [B,HD,T,W_t,ws,ws,nH,nW]. The plain version of B5
    (ops/nls_vol_cuda.py)."""
    T, (H, W) = vid0.shape[2], vid0.shape[-2:]
    dev = vid0.device
    is_int = (itype == "int")
    nH, nW = num_queries(H, W, stride0)
    if is_int:
        stride1 = max(1, int(stride1))
        ctr_h, ctr_w = ctr_h.to(torch.int32), ctr_w.to(torch.int32)
    else:
        stride1 = float(stride1)
        ctr_h, ctr_w = ctr_h.to(vid0.dtype), ctr_w.to(vid0.dtype)
    tj_tab = torch.as_tensor(time_window_frames(T, wt), device=dev)
    return lattice_search(
        vid0, vid1, tj_tab[None, None, :, :, None, None], ctr_h, ctr_w,
        ws=ws, stride1=stride1,
        ref_h=(torch.arange(nH, device=dev) * stride0) % H,
        ref_w=(torch.arange(nW, device=dev) * stride0) % W,
        dist_type=dist_type, ps=ps, dilation=dilation,
        patch_offset=0 if use_adj else -(ps // 2),
        reflect_bounds_=reflect_bounds_, full_ws=full_ws, is_int=is_int)


def nls_search_volume(vid0, vid1, flows, *, ws, wt, ps, stride0, stride1,
                      dist_type="l2", dilation=1, reflect_bounds_=True,
                      full_ws=True, use_adj=False, itype="float"):
    """Exhaustive NonLocalSearch volume: `volume_at_centres` at the flows'
    `search_centres`.

    vid0/vid1 [B,HD,T,F,H,W]; flows [B,HDf,T,W_t or W_t-1,2,nH,nW].
    Returns dists [B,HD,T,W_t,ws,ws,nH,nW].
    """
    ctr_h, ctr_w = search_centres(vid0.shape, flows, wt=wt, stride0=stride0,
                                  itype=itype)
    return volume_at_centres(
        vid0, vid1, ctr_h, ctr_w, ws=ws, wt=wt, ps=ps, stride0=stride0,
        stride1=stride1, dist_type=dist_type, dilation=dilation,
        reflect_bounds_=reflect_bounds_, full_ws=full_ws, use_adj=use_adj,
        itype=itype)
