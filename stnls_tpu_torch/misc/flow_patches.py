"""Assess optical-flow quality by comparing flow-linked patches (PyTorch
port of stnls_tpu/misc/flow_patches.py: get_patches / get_mse).

Plain torch gathers. Positions are rounded half to even and reflected
once at the borders, as in the JAX module; a linked position whose flat
index still falls outside the frame reads NaN, as JAX's take_along_axis
fills it.
"""

import torch

from stnls_tpu_torch.utils.config import ConfigDict
from stnls_tpu_torch.ops.geometry import reflect_bounds


def _take(flat, idx):
    """flat [B,T,C,N] at idx [B,T,N] (broadcast over C) with numpy's
    negative indices and NaN beyond the range."""
    N = flat.shape[-1]
    idx = torch.where(idx < 0, idx + N, idx)
    ok = (idx >= 0) & (idx < N)
    out = torch.gather(flat, 3, idx.clamp(0, N - 1)[:, :, None].expand(
        flat.shape))
    return torch.where(ok[:, :, None], out, torch.full_like(out,
                                                            float("nan")))


def _unfold_at_flow(vid, flow, ps, direction):
    """Patches at flow-shifted positions of the next/prev frame vs the
    current frame's patches. vid [B,T,C,H,W], flow [B,T,2,H,W] ->
    ([B,T,ps*ps,C,H,W], the same)."""
    B, T, C, H, W = vid.shape
    dev = vid.device
    hs = torch.arange(H, dtype=torch.float32, device=dev)[None, None, :, None]
    ws_ = torch.arange(W, dtype=torch.float32, device=dev)[None, None, None]
    nh = torch.round(reflect_bounds(hs + flow[:, :, 1], H)).long()
    nw = torch.round(reflect_bounds(ws_ + flow[:, :, 0], W)).long()
    tgt = (torch.arange(T, device=dev) + direction).clamp(0, T - 1)
    vtf = vid[:, tgt].reshape(B, T, C, H * W)
    off = -(ps // 2)
    cur, lnk = [], []
    for pi in range(ps):
        for pj in range(ps):
            ph = reflect_bounds(torch.arange(H, device=dev) + pi + off, H)
            pw = reflect_bounds(torch.arange(W, device=dev) + pj + off, W)
            cur.append(vid[:, :, :, ph][:, :, :, :, pw])
            qh = reflect_bounds(nh + pi + off, H)
            qw = reflect_bounds(nw + pj + off, W)
            lnk.append(_take(vtf, (qh * W + qw).reshape(B, T, H * W))
                       .reshape(B, T, C, H, W))
    return torch.stack(cur, 2), torch.stack(lnk, 2)


def get_patches(vid, flows, ps):
    """Current and flow-linked patches for fflow/bflow."""
    out = ConfigDict()
    out.fflow = _unfold_at_flow(vid, flows.fflow, ps, +1)
    out.bflow = _unfold_at_flow(vid, flows.bflow, ps, -1)
    return out


def get_mse(vid, flows, ps):
    """Per-direction mean squared error between flow-linked patches — the
    flow-quality score."""
    patches = get_patches(vid, flows, ps)
    mse = ConfigDict()
    for key in ("fflow", "bflow"):
        cur, lnk = patches[key]
        mse[key] = float(((cur - lnk) ** 2).mean())
    return mse
