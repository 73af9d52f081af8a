"""Geometry core: index math shared by every stnls_tpu_torch op.

PyTorch port of stnls_tpu/ops/geometry.py. Everything works on tensors
with *static* shape parameters and is differentiable where the reference
is: reflection is piecewise-linear, so autograd recovers the reference's
hand-written sign tracking.
"""

import numpy as np
import torch


def reflect_bounds(val, lim):
    """Single reflection at the boundary: -1 -> 1, lim -> lim-2.

    Works on int or float tensors. Only a single reflection is applied.
    """
    out = torch.where(val < 0, -val, val)
    return torch.where(val > (lim - 1), 2 * (lim - 1) - val, out)


def in_interval(val, lower, upper):
    """lower <= val <= upper-1 (inclusive of upper-1)."""
    return (val >= lower) & (val <= (upper - 1))


def in_bounds(val, upper):
    return in_interval(val, 0, upper)


def num_queries(H, W, stride0):
    """Query-grid size along each axis for a given stride (nH, nW)."""
    return (H - 1) // stride0 + 1, (W - 1) // stride0 + 1


def time_window_frames(T, wt):
    """Static [T, W_t] table: target frame tj for (query frame ti, slot st).

    Slots walk forward from ti to t_max, then wrap to ti-1, ti-2, ...
    (boundary-shifted window). W_t = min(2*wt+1, T).
    """
    W_t = min(2 * wt + 1, T)
    table = np.zeros((T, W_t), dtype=np.int64)
    for ti in range(T):
        t_shift = min(0, ti - wt) + max(0, ti + wt - (T - 1))
        t_max = min(T - 1, ti + wt - t_shift)
        for st in range(W_t):
            tj = ti + st
            table[ti, st] = tj if tj <= t_max else t_max - st
    return table


def search_offsets(hi, wi, stride1, ws, H, W, full_ws, is_int):
    """Window offset (wsOff_h, wsOff_w) per search centre.

    `hi`/`wi` are tensors of centre coordinates; `stride1` may be
    fractional in the float path. With full_ws the offsets shift so the
    whole ws-window stays inside the image.
    """
    wsHalf = (ws - 1) // 2
    dtype = torch.int32 if is_int else hi.dtype

    def one_axis(xi, L):
        off = torch.full_like(xi, wsHalf, dtype=dtype)
        if not full_ws:
            return off
        # first lattice point >= 0 (stride1 * wsHalf is a host product,
        # as in the reference)
        off_min = torch.floor(xi / (1.0 * stride1)).to(dtype)
        off = torch.where(xi - stride1 * wsHalf < 0, off_min, off)
        # last lattice point <= L-1
        x_max = xi + stride1 * ((ws - 1) - off)
        off_max = torch.ceil((xi - (L - 1)) / (1.0 * stride1)
                             + (ws - 1)).to(dtype)
        off = torch.where(x_max > (L - 1), off_max, off)
        if not is_int:
            off = torch.round(off)
        return off

    return one_axis(hi, H), one_axis(wi, W)


def bilinear_gather(frame, hi, wi, H, W):
    """Bilinearly interpolate `frame` [..., H, W] at float coords (hi, wi).

    Out-of-bounds corners contribute zero. hi/wi index the last two axes
    of `frame`; the result has the broadcast shape of frame's leading
    dims and (hi, wi).
    """
    h0 = torch.floor(hi)
    w0 = torch.floor(wi)
    out = None
    for di in (0, 1):
        for dj in (0, 1):
            hc = h0 + di
            wc = w0 + dj
            wgt = (torch.clamp(1.0 - torch.abs(hc - hi), min=0.0)
                   * torch.clamp(1.0 - torch.abs(wc - wi), min=0.0))
            valid = in_bounds(hc, H) & in_bounds(wc, W)
            hci = torch.clamp(hc, 0, H - 1).long()
            wci = torch.clamp(wc, 0, W - 1).long()
            pix = frame[..., hci, wci]
            term = torch.where(valid, wgt, torch.zeros_like(wgt)) * pix
            out = term if out is None else out + term
    return out
