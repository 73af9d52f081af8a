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


def reflect_bounds_clip(val, lim):
    """Reflection with a fallback clip for |val| >= lim: a value that one
    reflection leaves outside [0, lim-1] goes to the nearest border."""
    below = torch.where(-val > (lim - 1), torch.zeros_like(val), -val)
    over = 2 * (lim - 1) - val
    above = torch.where(over < 0, torch.full_like(val, lim - 1), over)
    out = torch.where(val < 0, below, val)
    return torch.where(val > (lim - 1), above, out)


def in_interval(val, lower, upper):
    """lower <= val <= upper-1 (inclusive of upper-1)."""
    return (val >= lower) & (val <= (upper - 1))


def in_bounds(val, upper):
    return in_interval(val, 0, upper)


def num_queries(H, W, stride0):
    """Query-grid size along each axis for a given stride (nH, nW)."""
    return (H - 1) // stride0 + 1, (W - 1) // stride0 + 1


def pixel_grid(T, nH, nW, stride, H, W, device=None):
    """Reference pixel locations of the query grid: int64 tensors
    (t [T], h [nH], w [nW]) with h = (i * stride) % H (the modulo is a
    no-op for legal grids)."""
    return (torch.arange(T, device=device),
            (torch.arange(nH, device=device) * stride) % H,
            (torch.arange(nW, device=device) * stride) % W)


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


def flat_gather(frames_flat, idx, fill=0.0, valid=None):
    """Gather along the flattened last axis, `fill` where `valid` is
    False. frames_flat [..., N]; idx an integer tensor of the same leading
    dims."""
    took = torch.gather(frames_flat, -1, idx.long())
    if valid is not None:
        took = torch.where(valid, took, torch.full_like(took, fill))
    return took


def put_dropped(out, index, values, sizes):
    """out.index_put(index, values) with the JAX package's
    .at[].set(mode="drop") semantics, deterministic on every device: an
    entry whose index falls outside `sizes` is dropped (a negative one
    counts from the end, down to -size; torch's index_put raises there on
    the CPU and faults on the card), and of several entries that set one
    element the last in order wins, as XLA's scatter on the CPU applies
    them (torch's index_put keeps an unspecified one on the card). The
    index tensors broadcast to one shape, the leading dims of `values`;
    `out` is not modified."""
    lead = torch.broadcast_shapes(*(i.shape for i in index))
    keep = torch.ones(lead, dtype=torch.bool, device=out.device)
    flat = torch.zeros(lead, dtype=torch.long, device=out.device)
    for i, n in zip(index, sizes):
        i = i.expand(lead).long()
        i = torch.where(i < 0, i + n, i)
        keep &= (i >= 0) & (i < n)
        flat = flat * n + i
    flat, values = flat[keep], values[keep]
    ordered, perm = torch.sort(flat, stable=True)
    last = torch.ones_like(ordered, dtype=torch.bool)
    last[:-1] = ordered[1:] != ordered[:-1]
    sel = perm[last]
    target = out.reshape((-1,) + tuple(out.shape[len(sizes):]))
    return target.index_put((flat[sel],), values[sel]).reshape(out.shape)
