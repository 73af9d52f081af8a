"""Sparse top-K re-evaluation of search distances (PyTorch port of
stnls_tpu/ops/nls_k.py).

Given the selected window cells (integer ids chosen under no_grad by the
search kernel or its plain version), `cells_geometry` turns the flows and
cells into the sampled key positions, target frames, validity and the
offsets the gather reads: the part of the search that stays in torch and
carries the flow gradient (reflection sign flips, head broadcast).
`dists_at_positions` evaluates the K patch distances at those positions
with plain differentiable torch; its autograd is the function of the
search backward kernel (B2, ops/nls_cuda.py), which takes its place on
the card. `nls_dists_at_cells` is the composition of the two.
`aux_to_inds3` materializes the offsets of every window cell, which the
full-volume search path (search.non_local_search) ranks.

All of them take the temporal-chunk mode of time sharding (query_t0,
T_global; ops/nls.chunk_frames): the window follows the query's global
frame, the target frames index halo-padded videos, and dt stays the
global difference, as stnls_tpu/ops/nls_pallas.py::_build_inputs builds
its tables.
"""

import torch
import torch.nn.functional as F_

from stnls_tpu_torch.ops.geometry import (
    reflect_bounds, in_bounds, num_queries, search_offsets,
)
from stnls_tpu_torch.ops.nls import (
    dist_type_select, _expand_flow_heads, _slot_flows, search_centres,
    window_tables,
)
from stnls_tpu_torch.ops.pgather import patch_gather, pad_frames_cf


def search_aux(vid_shape, flows, *, ws, wt, stride0, stride1, itype="float",
               full_ws=True, query_t0=None, T_global=None):
    """Separable offset factors of the search volume (geometry only, no
    video reads): dict(dt_tab [T,W_t], dh [B,HD,T,W_t,ws,nH,nW], dw
    likewise, and the reflected centres ctr_h, ctr_w [B,HD,T,W_t,nH,nW] of
    ops/nls.search_centres), T the flows' query frames. Feeds the anchor
    of the top-K selection rule (search.non_local_search._pallas_topk_aux)
    and the volume path."""
    H, W = vid_shape[-2:]
    T = flows.shape[2]
    dev = flows.device
    is_int = (itype == "int")
    stride1 = float(max(1, int(stride1))) if is_int else float(stride1)
    ctr_h, ctr_w = search_centres(vid_shape, flows, wt=wt, stride0=stride0,
                                  itype=itype, T_global=T_global)
    nH, nW = ctr_h.shape[-2:]
    base_h = (torch.arange(nH, device=dev) * stride0) % H
    base_w = (torch.arange(nW, device=dev) * stride0) % W
    bh = base_h[None, None, None, None, :, None].float()
    bw = base_w[None, None, None, None, None, :].float()
    off_h, off_w = search_offsets(ctr_h, ctr_w, stride1, ws, H, W,
                                  full_ws, False)
    cells_w = torch.arange(ws, device=dev, dtype=torch.float32)
    prop_h = ctr_h[:, :, :, :, None] + stride1 * (
        cells_w[:, None, None] - off_h[:, :, :, :, None])
    prop_w = ctr_w[:, :, :, :, None] + stride1 * (
        cells_w[:, None, None] - off_w[:, :, :, :, None])
    _, dt = window_tables(T, wt, t0=query_t0 or 0, T_global=T_global,
                          device=dev)
    cdtype = torch.int32 if is_int else torch.float32
    dt = dt.to(cdtype)
    dh = prop_h - bh[:, :, :, :, None]        # [B,HD,T,W_t,ws,nH,nW]
    dw = prop_w - bw[:, :, :, :, None]
    if is_int:
        dh = dh.to(cdtype)
        dw = dw.to(cdtype)
    return dict(dt_tab=dt, dh=dh, dw=dw, ctr_h=ctr_h, ctr_w=ctr_w)


def cells_geometry(flows, cells, *, H, W, ws, wt, stride0, stride1,
                   full_ws=True, itype="float", query_t0=None, T_global=None,
                   halo=0):
    """Geometry of the selected window cells, with no video reads.

    flows [B,HD(f),T,W_t(-1),2,nH,nW] (channel 0 = w, 1 = h); cells int
    [B,HD,T,nH,nW,K] flat ids (st*ws + wi)*ws + wj (no grad). Returns a
    dict of [B,HD,T,nH,nW,K] tensors: the sampled key positions prop_h,
    prop_w (float, differentiable in the flows in the float path: the
    reflection sign flips and the head broadcast happen here, in torch),
    the target frame tj_k (long), the validity mask `valid` (window
    positions inside the frame) and the offsets dt, dh, dw that the gather
    reads (int32 in the int path). In chunk mode (query_t0, T_global) tj_k
    indexes videos with `halo` frames before the first query frame.
    """
    HD, T = cells.shape[1], cells.shape[2]
    dev = cells.device
    is_int = (itype == "int")
    if is_int:
        stride1 = float(max(1, int(stride1)))
        flows = torch.round(flows)
    else:
        stride1 = float(stride1)
    T_global = T if T_global is None else T_global
    W_t = min(2 * wt + 1, T_global)
    nH, nW = num_queries(H, W, stride0)
    if cells.shape[-3:-1] != (nH, nW):
        raise ValueError("cells must cover the full query grid")
    flows = _expand_flow_heads(flows, HD)

    cells = cells.detach().long()
    st = cells // (ws * ws)
    wi = (cells % (ws * ws)) // ws
    wj = cells % ws

    # per-(q,k) flow at the selected temporal slot
    fH, fW = _slot_flows(flows, W_t)               # [B,HD,T,W_t,nH,nW]
    fH_k = torch.gather(fH.movedim(3, -1), -1, st)  # [B,HD,T,nH,nW,K]
    fW_k = torch.gather(fW.movedim(3, -1), -1, st)

    base_h = (torch.arange(nH, device=dev) * stride0) % H
    base_w = (torch.arange(nW, device=dev) * stride0) % W
    bh = base_h[None, None, None, :, None, None].float()
    bw = base_w[None, None, None, None, :, None].float()

    ctr_h = reflect_bounds(bh + fH_k, H)
    ctr_w = reflect_bounds(bw + fW_k, W)
    off_h, off_w = search_offsets(ctr_h.detach(), ctr_w.detach(), stride1,
                                  ws, H, W, full_ws, False)
    prop_h = ctr_h + stride1 * (wi.float() - off_h)
    prop_w = ctr_w + stride1 * (wj.float() - off_w)
    valid = in_bounds(prop_h, H) & in_bounds(prop_w, W)
    if is_int:
        prop_h = torch.round(prop_h)
        prop_w = torch.round(prop_w)

    # temporal target frame per (q, k), and its global difference
    tj_tab, dt_tab = window_tables(T, wt, t0=query_t0 or 0,
                                   T_global=T_global, halo=halo, device=dev)
    t_ids = torch.arange(T, device=dev)[None, None, :, None, None, None]
    odt = torch.int32 if is_int else torch.float32
    return dict(prop_h=prop_h, prop_w=prop_w, tj_k=tj_tab[t_ids, st],
                valid=valid, dt=dt_tab[t_ids, st].to(odt),
                dh=(prop_h - bh).to(odt), dw=(prop_w - bw).to(odt))


def dists_at_positions(vid0, vid1, prop_h, prop_w, tj_k, valid, *, ps,
                       stride0=1, dist_type="l2", dilation=1, use_adj=False,
                       itype="float"):
    """Patch distances at given key positions: the plain version of the
    search backward kernel (B2), whose autograd is that kernel's function.

    vid0/vid1 [B,HD,T,F,H,W]; prop_h/prop_w [B,HD,T,nH,nW,K] float key
    positions (integers in the int path); tj_k [..K] long target frames;
    valid [..K] bool. The query patch of vid0 and the key patch of vid1
    are read at reflected pixels (bilinear for float, at reflected
    corners). Returns dists [B,HD,T,nH,nW,K], differentiable in vid0, vid1
    and (float path) the positions; invalid cells carry init_val and zero
    gradients. In chunk mode the videos hold T + 2*halo frames: the
    queries are their interior, tj_k indexes them.
    """
    T = prop_h.shape[2]
    halo = (vid0.shape[2] - T) // 2
    vid0 = vid0[:, :, halo:halo + T]
    B, HD, T, F, H, W = vid0.shape
    nH, nW = num_queries(H, W, stride0)
    is_int = (itype == "int")
    patch_offset = 0 if use_adj else -(ps // 2)

    # key patch support gather; valid positions lie inside the frame, so a
    # single reflect fold of the taps' reach suffices
    Eh = dilation * (ps - 1)
    pad = Eh + 2
    if pad > min(H, W) - 1:
        raise ValueError("frame too small for single-fold pad")
    v1p, (Tp, Hp, Wp) = pad_frames_cf(vid1, pad)

    o_h = prop_h + dilation * patch_offset
    o_w = prop_w + dilation * patch_offset
    if is_int:
        S = Eh + 1
        oi = o_h.long() + pad
        oj = o_w.long() + pad
    else:
        S = Eh + 2
        fi = torch.floor(o_h)
        fj = torch.floor(o_w)
        fh = o_h - fi                    # carries the position gradient
        fw = o_w - fj
        oi = fi.long() + pad
        oj = fj.long() + pad
    P = patch_gather(v1p, (tj_k, oi, oj), (S, Tp, Hp, Wp))
    # P [B,HD,F,S,S,T,nH,nW,K]

    # query patches: static strided slices of the reflect-padded queries
    pad0 = Eh + 1
    v0p = F_.pad(vid0.float().reshape(B * HD * T, F, H, W),
                 (pad0, pad0, pad0, pad0), mode="reflect")
    v0p = v0p.reshape(B, HD, T, F, H + 2 * pad0, W + 2 * pad0) \
        .transpose(2, 3)                              # [B,HD,F,T,Hp0,Wp0]
    if not is_int:
        whc = (1. - fh, fh)
        wvc = (1. - fw, fw)
    acc = 0.
    for pi in range(ps):
        a = dilation * pi
        rh = pad0 + dilation * (pi + patch_offset)
        for pj in range(ps):
            b = dilation * pj
            rw = pad0 + dilation * (pj + patch_offset)
            p0 = v0p[..., rh:rh + (nH - 1) * stride0 + 1:stride0,
                     rw:rw + (nW - 1) * stride0 + 1:stride0][..., None]
            if is_int:
                pv = P[:, :, :, a, b]
            else:
                pv = 0.
                for u in (0, 1):
                    for v in (0, 1):
                        wgt = (whc[u] * wvc[v])[:, :, None]
                        pv = pv + wgt * P[:, :, :, a + u, b + v]
            # pv [B,HD,F,T,nH,nW,K]
            if dist_type == "l2":
                dfd = p0 - pv
                acc = acc + torch.sum(dfd * dfd, dim=2)
            else:
                acc = acc + torch.sum(p0 * pv, dim=2)

    _, _, init_val = dist_type_select(dist_type)
    return torch.where(valid, acc, torch.full_like(acc, init_val)) \
        .to(vid0.dtype)


def nls_dists_at_cells(vid0, vid1, flows, cells, *, ws, wt, ps, stride0,
                       stride1, dist_type="l2", dilation=1, full_ws=True,
                       use_adj=False, itype="float", query_t0=None,
                       T_global=None):
    """Differentiably recompute search distances at selected window cells:
    `cells_geometry` then `dists_at_positions`.

    vid0/vid1 [B,HD,T,F,H,W]; flows [B,HD,T,W_t(-1),2,nH,nW]; cells int
    [B,HD,T,nH,nW,K] holding flat ids (st*ws + wi)*ws + wj (no grad).

    Returns (dists [B,HD,T,nH,nW,K], (dt, dh, dw) offsets each
    [B,HD,T,nH,nW,K]), differentiable in vid0, vid1 and (float path)
    flows. Invalid cells (window positions outside the frame) carry
    init_val and zero gradients.
    """
    H, W = vid0.shape[-2:]
    geo = cells_geometry(flows, cells, H=H, W=W, ws=ws, wt=wt,
                         stride0=stride0, stride1=stride1, full_ws=full_ws,
                         itype=itype, query_t0=query_t0, T_global=T_global,
                         halo=(vid0.shape[2] - cells.shape[2]) // 2)
    dists = dists_at_positions(
        vid0, vid1, geo["prop_h"], geo["prop_w"], geo["tj_k"], geo["valid"],
        ps=ps, stride0=stride0, dist_type=dist_type, dilation=dilation,
        use_adj=use_adj, itype=itype)
    odt = torch.int32 if itype == "int" else vid0.dtype
    return dists, tuple(geo[key].to(odt) for key in ("dt", "dh", "dw"))


def aux_to_inds3(aux, shape8):
    """The full offset volume inds3 [3, B,HD,T,W_t,ws,ws,nH,nW] (dt, dh,
    dw) from the separable factors of `search_aux`, differentiable in the
    flows through dh and dw (float path)."""
    dt = aux["dt_tab"][None, None, :, :, None, None, None, None]
    dh = aux["dh"][:, :, :, :, :, None]            # broadcast over wj
    dw = aux["dw"][:, :, :, :, None, :]            # broadcast over wi
    return torch.stack([x.expand(shape8) for x in (dt, dh, dw)], dim=0)
