"""Naive per-query-loop ground truth for the non-local search (the
port's own copy of stnls_tpu/testing/nls_gt.py, which imports nothing of
JAX; the two are held bitwise equal by the port's tests).

Plays the role the reference's pure-python GTs play in its test suite
(tests/search/test_non_local_search_int.py:51-133): an independent,
obviously-correct implementation of the kernel semantics
(non_local_search_{int,bilin2d}_kernel.cu). Pure numpy, on numpy arrays or CPU
tensors; O(Q * W_t * ws^2 * ps^2 * F).
"""

import math
import numpy as np


def bounds(val, lim):
    if val < 0:
        return -val
    if val > lim - 1:
        return 2 * (lim - 1) - val
    return val


def in_bounds(val, lim):
    return 0 <= val <= lim - 1


def set_search_offsets(hi, wi, stride1, wsHalf, ws, H, W, full_ws, is_int):
    if not full_ws:
        return wsHalf, wsHalf
    offs = []
    for xi, L in ((hi, H), (wi, W)):
        off = wsHalf
        if xi - stride1 * wsHalf < 0:
            off = math.floor(xi / (1.0 * stride1))
        x_max = xi + stride1 * ((ws - 1) - off)
        if x_max > L - 1:
            off = math.ceil((xi - (L - 1)) / (1.0 * stride1) + (ws - 1))
        if not is_int:
            off = round(off)
        offs.append(off)
    return offs[0], offs[1]


def time_grid(ti, wt, T, W_t):
    t_shift = min(0, ti - wt) + max(0, ti + wt - (T - 1))
    t_max = min(T - 1, ti + wt - t_shift)
    return [ti + st if ti + st <= t_max else t_max - st for st in range(W_t)]


def bilin2d(frame, hi, wi, H, W):
    """frame [F,H,W]; out-of-bounds corners contribute zero."""
    pix = np.zeros(frame.shape[0], frame.dtype)
    h0, w0 = math.floor(hi), math.floor(wi)
    for di in (0, 1):
        for dj in (0, 1):
            hc, wc = h0 + di, w0 + dj
            w_ = max(0., 1 - abs(hc - hi)) * max(0., 1 - abs(wc - wi))
            if not (in_bounds(hc, H) and in_bounds(wc, W)):
                continue
            pix += w_ * frame[:, hc, wc]
    return pix


def nls_search_gt(vid0, vid1, flows, *, ws, wt, ps, stride0, stride1,
                  strideQ=None, dist_type="l2", dilation=1, pt=1,
                  reflect_bounds=True, full_ws=True, use_adj=False,
                  off_Hq=0, off_Wq=0, itype="float"):
    """Returns (dists, inds) of shape [B,HD,T,nH,nW,W_t,ws,ws(,3)]."""
    vid0 = np.asarray(vid0, np.float64)
    vid1 = np.asarray(vid1, np.float64)
    flows = np.asarray(flows)
    B, HD, T, F, qH, qW = vid0.shape
    kH, kW = vid1.shape[-2:]
    is_int = itype == "int"
    if strideQ is None:
        strideQ = stride0
    if is_int:
        stride1 = max(1, int(stride1))
        flows = np.round(flows).astype(np.int64)
    patch_offset = 0 if use_adj else -(ps // 2)
    W_t = min(2 * wt + 1, T)
    nH = (kH - 1) // stride0 + 1
    nW = (kW - 1) // stride0 + 1
    st_offset = W_t - flows.shape[3]
    HDf = flows.shape[1]
    wsHalf = (ws - 1) // 2
    invalid = -np.inf if dist_type == "prod" else np.inf

    dists = np.zeros((B, HD, T, nH, nW, W_t, ws, ws))
    inds = np.zeros((B, HD, T, nH, nW, W_t, ws, ws, 3))

    for b in range(B):
        for hd in range(HD):
            hdf = hd % HDf
            for ti in range(T):
                tgrid = time_grid(ti, wt, T, W_t)
                for nh in range(nH):
                    for nw in range(nW):
                        ref = (ti, (nh * strideQ) % qH, (nw * strideQ) % qW)
                        adj = (ti, (nh * stride0) % kH, (nw * stride0) % kW)
                        if not is_int:
                            adj = ref
                        for st in range(W_t):
                            tj = tgrid[st]
                            if st >= st_offset:
                                fH = flows[b, hdf, ti, st - st_offset, 1, nh, nw]
                                fW = flows[b, hdf, ti, st - st_offset, 0, nh, nw]
                                ctr_h = bounds(adj[1] + fH, kH)
                                ctr_w = bounds(adj[2] + fW, kW)
                            else:
                                ctr_h, ctr_w = float(adj[1]), float(adj[2])
                                if is_int:
                                    ctr_h, ctr_w = adj[1], adj[2]
                            off_h, off_w = set_search_offsets(
                                ctr_h, ctr_w, stride1, wsHalf, ws, kH, kW,
                                full_ws, is_int)
                            for wi in range(ws):
                                for wj in range(ws):
                                    ph = ctr_h + stride1 * (wi - off_h)
                                    pw = ctr_w + stride1 * (wj - off_w)
                                    valid = in_bounds(ph, kH) and in_bounds(pw, kW)
                                    dist = 0.0
                                    if valid:
                                        for pk in range(pt):
                                            rt = bounds(ref[0] + pk, T)
                                            ptj = bounds(tj + pk, T)
                                            for pi in range(ps):
                                                rh = ref[1] + off_Hq + dilation * (pi + patch_offset)
                                                qh = ph + dilation * (pi + patch_offset)
                                                if reflect_bounds:
                                                    rh = bounds(rh, qH)
                                                    qh = bounds(qh, kH)
                                                for pj in range(ps):
                                                    rw = ref[2] + off_Wq + dilation * (pj + patch_offset)
                                                    qw = pw + dilation * (pj + patch_offset)
                                                    if reflect_bounds:
                                                        rw = bounds(rw, qW)
                                                        qw = bounds(qw, kW)
                                                    ok = (in_bounds(rh, qH) and in_bounds(rw, qW)
                                                          and in_bounds(qh, kH) and in_bounds(qw, kW))
                                                    if not ok:
                                                        continue
                                                    pix0 = vid0[b, hd, rt, :, rh, rw]
                                                    if is_int:
                                                        pix1 = vid1[b, hd, ptj, :, int(qh), int(qw)]
                                                    else:
                                                        pix1 = bilin2d(
                                                            vid1[b, hd, int(round(ptj))],
                                                            qh, qw, kH, kW)
                                                    if dist_type == "prod":
                                                        dist += float(np.sum(pix0 * pix1))
                                                    else:
                                                        dist += float(np.sum((pix0 - pix1) ** 2))
                                    dists[b, hd, ti, nh, nw, st, wi, wj] = \
                                        dist if valid else invalid
                                    inds[b, hd, ti, nh, nw, st, wi, wj] = \
                                        (tj - ti, ph - adj[1], pw - adj[2])
    return dists, inds
