"""Flow composition ops (PyTorch port of stnls_tpu/ops/flow_ops.py).

Per-frame optical flows are composed into multi-frame offsets by
repeatedly bilinearly sampling the next frame's flow at the current
accumulated position, with out-of-bounds corners reflect-indexed (not
zeroed). `search_flow` dispatches by device: CUDA tensors go to the
hand-written walk (ops/flow_cuda: F1, backward F2), CPU tensors to
`search_flow_plain`, its plain version. The plain walks are Python loops
over the window slots (search_flow_plain) or the frame steps
(accumulate_flow), vectorised over every query; autograd gives the
gradients to both flows. `non_local_inds` lays the search windows out as
absolute coordinates.
"""

import numpy as np
import torch

from stnls_tpu_torch.ops import flow_cuda
from stnls_tpu_torch.ops.geometry import (
    reflect_bounds, num_queries, time_window_frames, search_offsets,
)


def _sample_flow(flow, h, w, H, W):
    """Bilinear sample `flow` [B,T,2,H,W] at float coords h, w
    [B,T,nH,nW]; each corner is read at its reflected coordinate.
    Returns (dW, dH) sampled at (h, w)."""
    B, T = flow.shape[:2]
    h0 = torch.floor(h)
    w0 = torch.floor(w)
    fh = h - h0
    fw = w - w0
    h0 = h0.long()
    w0 = w0.long()
    planes = flow.reshape(B, T, 2, H * W)
    n = h.shape[-2] * h.shape[-1]
    outW, outH = 0., 0.
    for di in (0, 1):
        hr = reflect_bounds(h0 + di, H).clamp(0, H - 1)
        wh = torch.clamp(1. - torch.abs(di - fh), min=0.)
        for dj in (0, 1):
            wr = reflect_bounds(w0 + dj, W).clamp(0, W - 1)
            wgt = wh * torch.clamp(1. - torch.abs(dj - fw), min=0.)
            idx = (hr * W + wr).reshape(B, T, 1, n).expand(B, T, 2, n)
            val = torch.gather(planes, 3, idx).reshape(
                (B, T, 2) + h.shape[-2:])
            outW = outW + wgt * val[:, :, 0]
            outH = outH + wgt * val[:, :, 1]
    return outW, outH


def search_flow(fflow, bflow, wt, stride0=1):
    """Compose fflow/bflow into the W_t-1 search-window offsets.

    fflow/bflow [B,T,2,H,W] -> flows [B,T,W_t-1,2,nH,nW]; slot si-1 holds
    the accumulated offset from frame ti to the si-th frame of the
    boundary-shifted window. CPU tensors take `search_flow_plain`, CUDA
    tensors the kernel walk (flow_cuda.search_flow), bitwise equal to it
    on the card.
    """
    if fflow.device.type == "cpu" or wt <= 0:
        return search_flow_plain(fflow, bflow, wt, stride0)
    return flow_cuda.search_flow(fflow, bflow, wt, stride0)


def search_flow_plain(fflow, bflow, wt, stride0=1):
    """Plain version of `search_flow` (F1's yardstick; autograd through it
    is F2's): a Python loop over the window slots."""
    B, T, _, H, W = fflow.shape
    W_t = min(2 * wt + 1, T)
    nH, nW = num_queries(H, W, stride0)
    if wt <= 0:
        return fflow.new_zeros((B, T, 0, 2, nH, nW))

    # static walk tables per (ti, si)
    swaps = np.zeros((T, W_t), bool)
    frame_pick = np.zeros((T, W_t), np.int64)
    use_fwd = np.zeros((T, W_t), bool)
    for ti in range(T):
        t_shift = min(0, ti - wt) + max(0, ti + wt - (T - 1))
        t_max = min(T - 1, ti + wt - t_shift)
        for si in range(1, W_t):
            tj = ti + si
            tj = tj if tj <= t_max else t_max - si
            # the forward run just ended: restart the walk from the query
            swaps[ti, si] = (ti + si - 1) == t_max
            use_fwd[ti, si] = tj > ti
            frame_pick[ti, si] = tj - 1 if tj > ti else tj + 1

    dev = fflow.device
    h_ref = (torch.arange(nH, device=dev, dtype=fflow.dtype) * stride0)
    w_ref = (torch.arange(nW, device=dev, dtype=fflow.dtype) * stride0)
    h_ref = h_ref[None, None, :, None].expand(B, T, nH, nW)
    w_ref = w_ref[None, None, None, :].expand(B, T, nH, nW)
    h_curr, w_curr = h_ref, w_ref
    outs = []
    for si in range(1, W_t):
        swap = torch.as_tensor(swaps[:, si], device=dev)[None, :, None, None]
        h_curr = torch.where(swap, h_ref, h_curr)
        w_curr = torch.where(swap, w_ref, w_curr)
        pick = torch.as_tensor(frame_pick[:, si], device=dev)
        fwd = torch.as_tensor(use_fwd[:, si], device=dev)
        flow = torch.where(fwd[None, :, None, None, None],
                           fflow[:, pick], bflow[:, pick])
        dW, dH = _sample_flow(flow, h_curr, w_curr, H, W)
        h_curr = h_curr + dH
        w_curr = w_curr + dW
        outs.append(torch.stack([w_curr - w_ref, h_curr - h_ref], dim=2))
    return torch.stack(outs, dim=2)


def accumulate_flow(fflow, bflow, stride0=1):
    """All-pairs accumulated flows: (pfflow, pbflow), each
    [B,T,T-1,2,nH,nW]; pfflow[:,ti,k] is the offset from frame ti to
    frame ti+k+1 (a walk along fflow), pbflow[:,ti,k] to frame ti-k-1
    (along bflow). A step past the sequence's end keeps the last
    position."""
    B, T, _, H, W = fflow.shape
    nH, nW = num_queries(H, W, stride0)
    dev = fflow.device
    h_ref = (torch.arange(nH, device=dev, dtype=fflow.dtype) * stride0)
    w_ref = (torch.arange(nW, device=dev, dtype=fflow.dtype) * stride0)
    h_ref = h_ref[None, None, :, None].expand(B, T, nH, nW)
    w_ref = w_ref[None, None, None, :].expand(B, T, nH, nW)

    def walk(flow, direction):
        h_curr, w_curr = h_ref, w_ref
        outs = []
        for k in range(T - 1):
            # frame ti + direction*k's flow moves the walk one frame on
            pick = torch.tensor([min(max(ti + direction * k, 0), T - 1)
                                 for ti in range(T)], device=dev)
            ok = torch.tensor([0 <= ti + direction * (k + 1) < T
                               for ti in range(T)], device=dev)
            dW, dH = _sample_flow(flow[:, pick], h_curr, w_curr, H, W)
            okb = ok[None, :, None, None]
            h_curr = torch.where(okb, h_curr + dH, h_curr)
            w_curr = torch.where(okb, w_curr + dW, w_curr)
            outs.append(torch.stack([w_curr - w_ref, h_curr - h_ref], dim=2))
        if not outs:
            return fflow.new_zeros((B, T, 0, 2, nH, nW))
        return torch.stack(outs, dim=2)

    return walk(fflow, +1), walk(bflow, -1)


def extract_search_from_accumulated(pfflow, pbflow, wt, T):
    """The W_t-1 search-window offsets [B,T,W_t-1,2,nH,nW] out of the
    all-pairs volumes of `accumulate_flow`."""
    W_t = min(2 * wt + 1, T)
    tj_tab = time_window_frames(T, wt)
    outs = []
    for ti in range(T):
        slots = []
        for si in range(1, W_t):
            tj = int(tj_tab[ti, si])
            slots.append(pfflow[:, ti, tj - ti - 1] if tj > ti
                         else pbflow[:, ti, ti - tj - 1])
        outs.append(torch.stack(slots, dim=1))
    return torch.stack(outs, dim=1)


def index_grid(T, nH, nW, dtype=torch.float32, device=None):
    """Absolute (t, h, w) coordinate grid [3, T, nH, nW]."""
    t, h, w = torch.meshgrid(torch.arange(T, dtype=dtype, device=device),
                             torch.arange(nH, dtype=dtype, device=device),
                             torch.arange(nW, dtype=dtype, device=device),
                             indexing="ij")
    return torch.stack([t, h, w], dim=0)


def non_local_inds(fflow, bflow, ws, wt, stride0, stride1):
    """Absolute float (t, h, w) coordinates of the whole search grid, no
    distances: the flow-shifted window centres (search_flow) laid out as
    the ws x ws lattice of each window frame (full_ws). Returns
    [3,B,T,W_t,ws,ws,nH,nW]."""
    B, T, _, H, W = fflow.shape
    nH, nW = num_queries(H, W, stride0)
    W_t = min(2 * wt + 1, T)
    dev = fflow.device
    flows = search_flow(fflow, bflow, wt, stride0)   # [B,T,W_t-1,2,nH,nW]
    tj_tab = torch.as_tensor(time_window_frames(T, wt), device=dev)
    base_h = (torch.arange(nH, device=dev, dtype=fflow.dtype)
              * stride0)[:, None]
    base_w = torch.arange(nW, device=dev, dtype=fflow.dtype) * stride0
    flows_full = torch.cat([flows.new_zeros((B, T, 1, 2, nH, nW)), flows],
                           dim=2)
    ctr_h = reflect_bounds(base_h + flows_full[:, :, :, 1], H)
    ctr_w = reflect_bounds(base_w + flows_full[:, :, :, 0], W)
    off_h, off_w = search_offsets(ctr_h, ctr_w, float(stride1), ws, H, W,
                                  True, False)
    cells = torch.arange(ws, device=dev, dtype=fflow.dtype)
    # [B,T,W_t,ws,nH,nW]
    ph = ctr_h[:, :, :, None] + stride1 * (cells[:, None, None]
                                           - off_h[:, :, :, None])
    pw = ctr_w[:, :, :, None] + stride1 * (cells[:, None, None]
                                           - off_w[:, :, :, None])
    shape = (B, T, W_t, ws, ws, nH, nW)
    tj = tj_tab[None, :, :, None, None, None, None].to(fflow.dtype)
    return torch.stack([tj.expand(shape), ph[:, :, :, :, None].expand(shape),
                        pw[:, :, :, None].expand(shape)], dim=0)
