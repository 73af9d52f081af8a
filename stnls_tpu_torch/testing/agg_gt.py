"""Naive loop ground truths for the aggregation ops (the port's own copy
of stnls_tpu/testing/agg_gt.py; role of the reference's
testing/non_local_gather_gt.py:48-181: nested loops, obviously correct,
used to validate the vectorized path). Pure numpy."""

import math
import numpy as np

from stnls_tpu_torch.testing.nls_gt import bounds, in_bounds


def bilin2d_pix(frame, hi, wi, H, W):
    """frame [F,H,W]: bilinear with out-of-bounds corners skipped
    (matches bilin2d_interpolate / ops.geometry.bilinear_gather)."""
    pix = np.zeros(frame.shape[0], frame.dtype)
    h0, w0 = math.floor(hi), math.floor(wi)
    for di in (0, 1):
        for dj in (0, 1):
            hc, wc = h0 + di, w0 + dj
            wgt = max(0., 1 - abs(hc - hi)) * max(0., 1 - abs(wc - wi))
            if not (in_bounds(hc, H) and in_bounds(wc, W)):
                continue
            pix += wgt * frame[:, hc, wc]
    return pix


def gather_stack_gt(vid, weights, flows, ps, stride0, reflect=True,
                    itype="float", pt=1, dilation=1):
    """NonLocalGather ground truth (gather_{int,bilin2d}.cu semantics)."""
    vid = np.asarray(vid, np.float64)
    weights = np.asarray(weights, np.float64)
    flows = np.asarray(flows)
    B, HD, T, F, H, W = vid.shape
    nH = (H - 1) // stride0 + 1
    nW = (W - 1) // stride0 + 1
    K = flows.shape[-2]
    weights = weights.reshape(B, HD, T, nH, nW, K)
    flows = flows.reshape(B, HD, T, nH, nW, K, 3)
    stack = np.zeros((B, HD, K, T, F, H, W))
    counts = np.zeros((H, W))
    off = -(ps // 2)
    for b in range(B):
        for hd in range(HD):
            for t in range(T):
                for nh in range(nH):
                    for nw in range(nW):
                        rh, rw = nh * stride0, nw * stride0
                        for k in range(K):
                            f = flows[b, hd, t, nh, nw, k]
                            w_ = weights[b, hd, t, nh, nw, k]
                            if itype == "int":
                                nt = bounds(int(round(f[0])) + t, T)
                                nlh = bounds(int(round(f[1])) + rh, H)
                                nlw = bounds(int(round(f[2])) + rw, W)
                            else:
                                nt = bounds(int(round(f[0])) + t, T)
                                nlh = bounds(f[1] + rh, H)
                                nlw = bounds(f[2] + rw, W)
                            for pk in range(pt):
                                rt = bounds(t + pk, T)
                                ntk = bounds(nt + pk, T)
                                for pi in range(ps):
                                    for pj in range(ps):
                                        rhp = rh + dilation * (pi + off)
                                        rwp = rw + dilation * (pj + off)
                                        nhp = nlh + dilation * (pi + off)
                                        nwp = nlw + dilation * (pj + off)
                                        if reflect:
                                            nhp = bounds(nhp, H)
                                            nwp = bounds(nwp, W)
                                        vr = in_bounds(rhp, H) and in_bounds(rwp, W)
                                        vn = in_bounds(nhp, H) and in_bounds(nwp, W)
                                        if (k == 0 and b == 0 and hd == 0
                                                and rt == 0 and vr and pk == 0):
                                            counts[rhp, rwp] += 1
                                        if not (vr and vn):
                                            continue
                                        if itype == "int":
                                            val = vid[b, hd, ntk, :,
                                                      int(nhp), int(nwp)]
                                        else:
                                            val = bilin2d_pix(
                                                vid[b, hd, ntk], nhp, nwp,
                                                H, W)
                                        stack[b, hd, k, rt, :, rhp, rwp] += \
                                            w_ * val
    return stack / (counts + 1e-10)
