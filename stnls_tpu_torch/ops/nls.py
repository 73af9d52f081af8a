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

Temporal-chunk mode (time sharding, stnls_tpu_torch/parallel): the
videos hold a rank's T_local query frames plus `halo` frames on each side,
and `query_t0` / `T_global` place the queries in the whole sequence, so
that the boundary-shifted windows are the whole video's (`chunk_frames`,
`window_tables`). `nls_search_volume_chunk` is the chunk volume.

`lattice_search` also takes what the search kernels do not: pt > 1,
reflect_bounds=False, a query grid of its own (strideQ, off_Hq/off_Wq),
the int path's ws_interior and the refine's skipped offsets; these are
the plain "lattice" route of the searches, on every device, as in
stnls_tpu. `refine_search_volume` is the RefineSearch volume (a wr x wr
lattice around given offsets) and `nls_search_core` the volume in the
reference's layout.
"""

import numpy as np
import torch

from stnls_tpu_torch.ops.geometry import (
    reflect_bounds, in_bounds, num_queries, search_offsets,
)

# dist_type menu
DIST_PROD = 0
DIST_L2 = 1

INVALID_IND = -1e8


def dist_type_select(dist_type):
    menu = {"prod": DIST_PROD, "l2": DIST_L2}
    descending = {"prod": True, "l2": False}
    init_val = {"prod": -np.inf, "l2": np.inf}
    return menu[dist_type], descending[dist_type], init_val[dist_type]


def _expand_flow_heads(flows, HD):
    """flows [B,HDf,...] -> per-head flows via ihead % HDf. The index is
    made on the flows' device: a host list copied to the card would
    synchronise the host with it at every call."""
    HDf = flows.shape[1]
    if HDf == HD:
        return flows
    reps = torch.arange(HD, device=flows.device) % HDf
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


def time_window_frames_t(tq, wt, T):
    """Boundary-shifted time window of global query frames: tq [T_q] int
    tensor -> tj [T_q, W_t] global target frames, W_t = min(2*wt+1, T).
    geometry.time_window_frames for any set of query frames."""
    W_t = min(2 * wt + 1, T)
    st = torch.arange(W_t, device=tq.device)
    t_shift = (tq - wt).clamp(max=0) + (tq + wt - (T - 1)).clamp(min=0)
    t_max = (tq + wt - t_shift).clamp(max=T - 1)[:, None]
    tj = tq[:, None] + st[None, :]
    return torch.where(tj > t_max, t_max - st[None, :], tj)


def chunk_frames(T_q, T_v, wt, query_t0=None, T_global=None):
    """(t0, T_global, halo) of T_q query frames read from videos of T_v
    frames. Without query_t0 and T_global the videos are the whole
    sequence: (0, T_q, 0). In chunk mode the videos hold the queries'
    frames plus halo = (T_v - T_q) / 2 frames on each side, which must
    cover the window's reach 2*wt; query_t0 is the global index of the
    first query frame. Raises ValueError on what does not fit."""
    if query_t0 is None and T_global is None:
        if T_v != T_q:
            raise ValueError(f"{T_v} video frames for {T_q} query frames "
                             "need query_t0 and T_global (chunk mode)")
        return 0, T_q, 0
    if query_t0 is None or T_global is None:
        raise ValueError("chunk mode takes both query_t0 and T_global")
    t0, T_g = int(query_t0), int(T_global)
    halo = (T_v - T_q) // 2
    if T_v < T_q or (T_v - T_q) % 2:
        raise ValueError(f"chunk mode: {T_v} video frames must be the "
                         f"{T_q} query frames plus two equal halos")
    if halo < 2 * wt:
        raise ValueError(f"chunk mode: a halo of {halo} frames does not "
                         f"cover the window's reach 2*wt = {2 * wt}")
    if t0 < 0 or t0 + T_q > T_g:
        raise ValueError(f"chunk mode: query frames {t0}..{t0 + T_q - 1} "
                         f"outside the {T_g} frames of the sequence")
    return t0, T_g, halo


def window_tables(T_q, wt, *, t0=0, T_global=None, halo=0, device=None):
    """The window of each query frame t0 + t (t < T_q) of a sequence of
    T_global frames (default T_q): (tj [T_q, W_t] the target frames as
    indices into videos that start `halo` frames before frame t0, dt
    [T_q, W_t] the global difference tj - tq), int64."""
    T_global = T_q if T_global is None else T_global
    tq = t0 + torch.arange(T_q, device=device)
    tjg = time_window_frames_t(tq, wt, T_global)
    return tjg - t0 + halo, tjg - tq[:, None]


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
                   ref_h, ref_w, dist_type, ps, dilation=1, pt=1,
                   patch_offset=0, reflect_bounds_=True, full_ws=True,
                   off_Hq=0, off_Wq=0, is_int=False, cell_mask=None,
                   edge_valid=None, G=None, query_t=None, base_h=None,
                   base_w=None, with_inds=False):
    """Shared search engine.

    ctr_t: int frame index per (b,hd,t,g,[nh,nw]), broadcastable to
    [B,HD,T,G,nH,nW]; ctr_h/ctr_w: reflected centre coordinates of that
    broadcast shape (int in the int path, float otherwise). ref_h/ref_w:
    [nH]/[nW] int query pixel grids (patch reads on vid0, shifted by
    off_Hq/off_Wq); base_h/base_w: the grids the offsets are relative to
    (default ref_h/ref_w). pt > 1 adds the patch's later frames, reflected
    in time. cell_mask: optional (off_h, off_w, mask8) window offsets and
    searched-cell mask precomputed by the caller (ws_interior);
    edge_valid: optional bool mask per (b,hd,t,g,nh,nw), False entries
    get init-valued dists and -1e8 offsets (the refine's 1e8 skip).
    query_t: optional int tensor [T_q] of the query frames' indices into
    vid0 (default arange(T)); time sharding sets it to the interior of
    halo-padded videos (pt = 1 only).

    Returns dists [B,HD,T_q,G,ws,ws,nH,nW], and with `with_inds` also the
    cells' offsets inds3 [3, ...same...] (dt, dh, dw; int32 in the int
    path). The search's own routes take the separable offsets of
    ops.nls_k.search_aux instead.
    """
    B, HD, T, F, qH, qW = vid0.shape
    kH, kW = vid1.shape[-2:]
    nH, nW = ref_h.shape[0], ref_w.shape[0]
    G = ctr_h.shape[3] if G is None else G
    dev = vid0.device
    cdtype = torch.int32 if is_int else vid0.dtype
    if not float(dilation).is_integer():
        # the query patch is read at integer pixels, as in stnls_tpu's
        # lattice, whose gather refuses the float index too
        raise TypeError(f"dilation={dilation}: the query patch's taps must "
                        "be integer pixels")
    dilation = int(dilation)
    t_ids = torch.arange(T, device=dev) if query_t is None \
        else query_t.to(dev).long()
    T_q = t_ids.shape[0]
    if query_t is not None and pt != 1:
        raise ValueError("query_t (time sharding) requires pt == 1")

    if cell_mask is None:
        off_h, off_w = search_offsets(ctr_h, ctr_w, stride1, ws, kH, kW,
                                      full_ws, is_int)
        mask8 = None
    else:
        off_h, off_w, mask8 = cell_mask
    cells = torch.arange(ws, device=dev, dtype=cdtype)
    # lattice positions [B,HD,T,G,ws,nH,nW]
    prop_h = ctr_h[..., None, :, :] + stride1 * (cells[:, None, None]
                                                 - off_h[..., None, :, :])
    prop_w = ctr_w[..., None, :, :] + stride1 * (cells[:, None, None]
                                                 - off_w[..., None, :, :])
    valid_patch = (in_bounds(prop_h, kH)[..., :, None, :, :]
                   & in_bounds(prop_w, kW)[..., None, :, :, :])

    cell_shape = (B, HD, T_q, G, ws, ws, nH, nW)
    v0_rows = _rows(vid0)
    v1_rows = _rows(vid1)
    bh = (torch.arange(B, device=dev)[:, None] * HD
          + torch.arange(HD, device=dev)[None, :]).reshape(B, HD, 1, 1, 1,
                                                          1, 1, 1)
    ctr_t8 = ctr_t.long()[..., None, None, :, :]

    acc = torch.zeros(cell_shape, dtype=vid0.dtype, device=dev)
    for pk in range(pt):
        rt = reflect_bounds(t_ids + pk, T)
        ptj = reflect_bounds(ctr_t8 + pk, T)
        for pi in range(ps):
            dH = dilation * (pi + patch_offset)
            rh = ref_h + off_Hq + dH
            ph = prop_h[..., :, None, :, :] + dH
            if reflect_bounds_:
                rh = reflect_bounds(rh, qH)
                ph = reflect_bounds(ph, kH)
            for pj in range(ps):
                dW = dilation * (pj + patch_offset)
                rw = ref_w + off_Wq + dW
                pw = prop_w[..., None, :, :, :] + dW
                if reflect_bounds_:
                    rw = reflect_bounds(rw, qW)
                    pw = reflect_bounds(pw, kW)
                # reference pixel (always an integer read)
                v_ref = in_bounds(rh, qH)[:, None] & in_bounds(rw, qW)[None, :]
                ridx = ((bh.reshape(B, HD, 1, 1, 1) * T
                         + rt[None, None, :, None, None]) * qH
                        + rh.clamp(0, qH - 1)[:, None]) * qW \
                    + rw.clamp(0, qW - 1)[None, :]        # [B,HD,T,nH,nW]
                p0 = v0_rows[ridx][:, :, :, None, None, None]
                v_prop = in_bounds(ph, kH) & in_bounds(pw, kW)
                fbase = (bh * T + ptj) * kH
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
                                   * torch.clamp(1. - torch.abs(wc - pw),
                                                 min=0.))
                            wgt = torch.where(in_bounds(hc, kH)
                                              & in_bounds(wc, kW),
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
    keep = valid_patch
    if mask8 is not None:
        keep = keep & mask8
    if edge_valid is not None:
        keep = keep & edge_valid[..., None, None, :, :]
    dists = torch.where(keep, acc, torch.full_like(acc, init_val))
    if not with_inds:
        return dists

    base_h = ref_h if base_h is None else base_h
    base_w = ref_w if base_w is None else base_w
    dt = (ctr_t8 - t_ids[:, None, None, None, None, None]).to(cdtype)
    dh = (prop_h - base_h[:, None].to(cdtype))[..., :, None, :, :]
    dw = (prop_w - base_w.to(cdtype))[..., None, :, :, :]
    inds3 = torch.stack([x.to(cdtype).expand(cell_shape)
                         for x in (dt, dh, dw)], dim=0)
    fill = torch.tensor(-100000000 if is_int else INVALID_IND, dtype=cdtype,
                        device=dev)
    if mask8 is not None:
        inds3 = torch.where(mask8, inds3, fill)
    if edge_valid is not None:
        inds3 = torch.where(edge_valid[..., None, None, :, :], inds3, fill)
    return dists, inds3


def search_centres(vid_shape, flows, *, wt, stride0, itype="float",
                   T_global=None, base_stride=None):
    """Reflected search centres of the W_t window slots: the query grid
    shifted by the flows. vid_shape (B,HD,T,F,H,W) (the key frames');
    flows [B,HDf,T_q,W_t or W_t-1,2,nH,nW] (channel 0 = w, 1 = h; the
    reference frame's slot is prepended with zero flow when missing), W_t =
    min(2*wt+1, T_global) with T_global = T unless given (chunk mode). The
    grid strides by base_stride (default stride0; the float path's strideQ
    in ops.nls.nls_search_volume). Returns (ctr_h, ctr_w) float
    [B,HD,T_q,W_t,nH,nW], differentiable in the flows (the reflection's
    sign included); integers in the int path, whose flows are rounded."""
    B, HD, T, F, H, W = vid_shape
    T = T if T_global is None else T_global
    dev = flows.device
    nH, nW = num_queries(H, W, stride0)
    stride = stride0 if base_stride is None else base_stride
    flows = _expand_flow_heads(flows, HD)
    if itype == "int":
        flows = torch.round(flows)
    fH, fW = _slot_flows(flows, min(2 * wt + 1, T))
    ref_h = (torch.arange(nH, device=dev) * stride) % H
    ref_w = (torch.arange(nW, device=dev) * stride) % W
    ctr_h = reflect_bounds(ref_h[:, None].float() + fH, H)
    ctr_w = reflect_bounds(ref_w[None, :].float() + fW, W)
    return ctr_h, ctr_w


def _interior_mask(ctr_h, ctr_w, *, ws, ws_interior, stride1, H, W,
                   full_ws):
    """The int path's per-query window (ws_interior): queries in the last
    row or column search ws x ws, the others ws_interior x ws_interior
    cells of the ws x ws lattice. Returns lattice_search's cell_mask
    (off_h, off_w, mask8)."""
    nH, nW = ctr_h.shape[-2:]
    dev = ctr_h.device
    btm_right = ((torch.arange(nH, device=dev) == nH - 1)[:, None]
                 | (torch.arange(nW, device=dev) == nW - 1)[None, :])
    ws_eff = torch.where(btm_right, ws, ws_interior)
    full, inner = (search_offsets(ctr_h, ctr_w, stride1, w, H, W, full_ws,
                                  True) for w in (ws, ws_interior))
    off_h = torch.where(btm_right, full[0], inner[0])
    off_w = torch.where(btm_right, full[1], inner[1])
    cells = torch.arange(ws, device=dev)
    mask8 = ((cells[:, None, None, None] < ws_eff)
             & (cells[None, :, None, None] < ws_eff))
    return off_h, off_w, mask8


def volume_at_centres(vid0, vid1, ctr_h, ctr_w, *, ws, wt, ps, stride0,
                      stride1, dist_type="l2", dilation=1,
                      reflect_bounds_=True, full_ws=True, use_adj=False,
                      itype="float", query_t0=None, T_global=None,
                      strideQ=None, pt=1, off_Hq=0, off_Wq=0, ws_interior=0,
                      with_inds=False):
    """The search volume at given reflected centres: `lattice_search` over
    the W_t window frames. vid0/vid1 [B,HD,T,F,H,W]; ctr_h, ctr_w
    [B,HD,T,W_t,nH,nW] (`search_centres`). Returns dists
    [B,HD,T,W_t,ws,ws,nH,nW] (and with `with_inds` the cells' offsets
    inds3 [3, ...same...]). In chunk mode (query_t0, T_global) the videos
    hold T_q + 2*halo frames and the centres T_q (`chunk_frames`), and
    the output covers the T_q query frames. The query patches are read at
    the strideQ grid (default stride0) shifted by off_Hq/off_Wq; in the
    int path ws_interior > 0 narrows the window of all but the last row
    and column of queries. With the defaults this is the plain version of
    B5 (ops/nls_vol_cuda.py)."""
    (qH, qW), (kH, kW) = vid0.shape[-2:], vid1.shape[-2:]
    T_q = ctr_h.shape[2]
    dev = vid0.device
    is_int = (itype == "int")
    nH, nW = num_queries(kH, kW, stride0)
    strideQ = stride0 if strideQ is None else strideQ
    t0, T_g, halo = chunk_frames(T_q, vid0.shape[2], wt, query_t0, T_global)
    if is_int:
        stride1 = max(1, int(stride1))
        ctr_h, ctr_w = ctr_h.to(torch.int32), ctr_w.to(torch.int32)
    else:
        stride1 = float(stride1)
        ctr_h, ctr_w = ctr_h.to(vid0.dtype), ctr_w.to(vid0.dtype)
    ref_h = (torch.arange(nH, device=dev) * strideQ) % qH
    ref_w = (torch.arange(nW, device=dev) * strideQ) % qW
    if is_int:
        # the window anchors stride by stride0 over the key frames
        base_h = (torch.arange(nH, device=dev) * stride0) % kH
        base_w = (torch.arange(nW, device=dev) * stride0) % kW
    else:
        base_h, base_w = ref_h, ref_w
    cell_mask = None
    if is_int and 0 < ws_interior != ws:
        cell_mask = _interior_mask(ctr_h, ctr_w, ws=ws,
                                   ws_interior=ws_interior, stride1=stride1,
                                   H=kH, W=kW, full_ws=full_ws)
    tj_tab, _ = window_tables(T_q, wt, t0=t0, T_global=T_g, halo=halo,
                              device=dev)
    return lattice_search(
        vid0, vid1, tj_tab[None, None, :, :, None, None], ctr_h, ctr_w,
        ws=ws, stride1=stride1, ref_h=ref_h, ref_w=ref_w,
        dist_type=dist_type, ps=ps, dilation=dilation, pt=pt,
        patch_offset=0 if use_adj else -(ps // 2),
        reflect_bounds_=reflect_bounds_, full_ws=full_ws, off_Hq=off_Hq,
        off_Wq=off_Wq, is_int=is_int, cell_mask=cell_mask,
        query_t=None if query_t0 is None else
        halo + torch.arange(T_q, device=dev),
        base_h=base_h, base_w=base_w, with_inds=with_inds)


def nls_search_volume(vid0, vid1, flows, *, ws, wt, ps, stride0, stride1,
                      strideQ=None, dist_type="l2", dilation=1, pt=1,
                      reflect_bounds_=True, full_ws=True, use_adj=False,
                      off_Hq=0, off_Wq=0, itype="float", ws_interior=0,
                      query_t0=None, T_global=None, with_inds=False):
    """Exhaustive NonLocalSearch volume: `volume_at_centres` at the flows'
    `search_centres`.

    vid0/vid1 [B,HD,T,F,H,W]; flows [B,HDf,T,W_t or W_t-1,2,nH,nW].
    Returns dists [B,HD,T,W_t,ws,ws,nH,nW], and with `with_inds` also the
    cells' offsets inds3 [3, ...same...], as stnls_tpu's returns both. In
    chunk mode (query_t0, T_global; `chunk_frames`) the flows and the
    output cover the query frames, the videos those plus their halos.
    """
    strideQ = stride0 if strideQ is None else strideQ
    key_shape = vid0.shape[:4] + vid1.shape[-2:]
    ctr_h, ctr_w = search_centres(
        key_shape, flows, wt=wt, stride0=stride0, itype=itype,
        T_global=T_global,
        base_stride=stride0 if itype == "int" else strideQ)
    return volume_at_centres(
        vid0, vid1, ctr_h, ctr_w, ws=ws, wt=wt, ps=ps, stride0=stride0,
        stride1=stride1, dist_type=dist_type, dilation=dilation,
        reflect_bounds_=reflect_bounds_, full_ws=full_ws, use_adj=use_adj,
        itype=itype, query_t0=query_t0, T_global=T_global, strideQ=strideQ,
        pt=pt, off_Hq=off_Hq, off_Wq=off_Wq, ws_interior=ws_interior,
        with_inds=with_inds)


def refine_search_volume(vid0, vid1, flows_k, *, ws, wr, ps, stride0,
                         stride1, strideQ=None, dist_type="l2", dilation=1,
                         pt=1, reflect_bounds_=True, full_ws=True,
                         use_adj=False, off_Hq=0, off_Wq=0, itype="float",
                         restricted_radius=False, rows=None):
    """RefineSearch volume: a wr x wr lattice (spacing stride1) around each
    of the Ks given per-query offsets.

    vid0/vid1 [B,HD,T,F,H,W]; flows_k [B,HDf,T,nH,nW,Ks,3] relative
    offsets (dt, dh, dw); an offset with |dh| or |dw| >= 1e8 (the
    search's invalid fill) is skipped: init-valued dists, -1e8 offsets.
    `rows`, a slice of query rows, restricts the output to them (the
    refine's selection runs in bands of rows). Returns (dists
    [B,HD,T,Ks,wr,wr,nH,nW], inds3 [3, ...same...]), the offsets relative
    to the query grid.

    `restricted_radius` is accepted and ignored, as in stnls_tpu and the
    reference's kernels; `ws` exists only to bound that dead option.
    """
    del ws, restricted_radius
    B, HD, T, F, qH, qW = vid0.shape
    kH, kW = vid1.shape[-2:]
    dev = vid0.device
    is_int = (itype == "int")
    nH, nW = num_queries(qH, qW, stride0)
    Ks = flows_k.shape[-2]
    strideQ = stride0 if strideQ is None else strideQ
    if is_int:
        stride1 = max(1, int(stride1))
        flows_k = torch.round(flows_k).to(torch.int32)
    else:
        stride1 = float(stride1)
    cdtype = torch.int32 if is_int else vid0.dtype
    ref_h = (torch.arange(nH, device=dev) * strideQ) % qH
    ref_w = (torch.arange(nW, device=dev) * strideQ) % qW
    flows_k = _expand_flow_heads(flows_k, HD)
    if rows is not None:
        ref_h, flows_k = ref_h[rows], flows_k[:, :, :, rows]
    # [B,HD,T,nH,nW,Ks,3] -> group-major [B,HD,T,Ks,nH,nW,3]
    fk = flows_k.movedim(5, 3)
    t_ids = torch.arange(T, device=dev)[None, None, :, None, None, None]
    dt = fk[..., 0].long() if is_int else torch.floor(fk[..., 0] + 0.5).long()
    ctr_t = reflect_bounds(t_ids + dt, T)
    ctr_h = reflect_bounds(ref_h[:, None].to(cdtype) + fk[..., 1], kH)
    ctr_w = reflect_bounds(ref_w.to(cdtype) + fk[..., 2], kW)
    edge_valid = (fk[..., 1].abs() < 1e8) & (fk[..., 2].abs() < 1e8)
    return lattice_search(
        vid0, vid1, ctr_t, ctr_h, ctr_w, ws=wr, stride1=stride1,
        ref_h=ref_h, ref_w=ref_w, dist_type=dist_type, ps=ps,
        dilation=dilation, pt=pt, patch_offset=0 if use_adj else -(ps // 2),
        reflect_bounds_=reflect_bounds_, full_ws=full_ws, off_Hq=off_Hq,
        off_Wq=off_Wq, is_int=is_int, edge_valid=edge_valid, G=Ks,
        with_inds=True)


def nls_search_core(vid0, vid1, flows, **kw):
    """Reference-layout volume: dists [B,HD,T,nH,nW,W_t,ws,ws] and inds
    [B,HD,T,nH,nW,W_t,ws,ws,3], from `nls_search_volume`'s keywords."""
    dists, inds3 = nls_search_volume(vid0, vid1, flows, with_inds=True, **kw)
    return (dists.permute(0, 1, 2, 6, 7, 3, 4, 5),
            inds3.permute(1, 2, 3, 7, 8, 4, 5, 6, 0))


def nls_search_volume_chunk(vid0_pad, vid1_pad, flows, *, t0, T_global, halo,
                            ws, wt, ps, stride0, stride1, dist_type="l2",
                            dilation=1, reflect_bounds_=True, full_ws=True,
                            use_adj=False, itype="float"):
    """Temporal-chunk search volume for time sharding (the port of
    stnls_tpu/ops/nls.py::nls_search_volume_chunk): the plain version of
    B5's chunk mode.

    vid*_pad [B,HD,T_local+2*halo,F,H,W] hold a rank's T_local frames and
    `halo` frames on each side (halo >= 2*wt; the wrap-around frames a
    ring exchange leaves at the sequence ends are never read); t0 is the
    global index of the first local frame; flows
    [B,HDf,T_local,W_t(-1),2,nH,nW] cover the local queries, W_t =
    min(2*wt+1, T_global). Returns dists [B,HD,T_local,W_t,ws,ws,nH,nW];
    the offsets of its cells are ops.nls_k.search_aux's in chunk mode.
    """
    if vid0_pad.shape[2] - 2 * halo != flows.shape[2]:
        raise ValueError("vid*_pad must hold the flows' frames plus halo "
                         "frames on each side")
    return nls_search_volume(
        vid0_pad, vid1_pad, flows, ws=ws, wt=wt, ps=ps, stride0=stride0,
        stride1=stride1, dist_type=dist_type, dilation=dilation,
        reflect_bounds_=reflect_bounds_, full_ws=full_ws, use_adj=use_adj,
        itype=itype, query_t0=t0, T_global=T_global)
