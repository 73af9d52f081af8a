"""Flow composition ops.

PyTorch port of stnls_tpu/ops/flow_ops.py::search_flow. Per-frame optical
flows are composed into multi-frame offsets by repeatedly bilinearly
sampling the next frame's flow at the current accumulated position, with
out-of-bounds corners reflect-indexed (not zeroed). The walk is a Python
loop over the W_t-1 window slots, vectorised over every query; autograd
gives the gradients to both flows.
"""

import numpy as np
import torch

from stnls_tpu_torch.ops.geometry import reflect_bounds, num_queries


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
    boundary-shifted window.
    """
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
