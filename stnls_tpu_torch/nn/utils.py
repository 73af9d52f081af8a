"""NN-layer utilities (PyTorch port of stnls_tpu/nn/utils.py): flow
rescaling to feature resolution."""

import torch

from stnls_tpu_torch.utils.config import ConfigDict


def _interp_bilinear(x, H, W):
    """Bilinear resize with align_corners=True semantics on [N,2,h,w]."""
    N, C, h, w = x.shape
    if h == H and w == W:
        return x
    ys = torch.linspace(0., h - 1., H, device=x.device, dtype=x.dtype)
    xs = torch.linspace(0., w - 1., W, device=x.device, dtype=x.dtype)
    y0 = torch.clamp(torch.floor(ys).long(), 0, h - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    x0 = torch.clamp(torch.floor(xs).long(), 0, w - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    wy = (ys - y0)[None, None, :, None]
    wx = (xs - x0)[None, None, None, :]

    def g(yi, xi):
        return x[:, :, yi][:, :, :, xi]

    return ((1 - wy) * (1 - wx) * g(y0, x0) + (1 - wy) * wx * g(y0, x1)
            + wy * (1 - wx) * g(y1, x0) + wy * wx * g(y1, x1))


def rescale_flows(flows_og, H, W):
    """Resize + rescale fflow/bflow to resolution (H, W)."""
    if flows_og is None:
        return None
    fshape = list(flows_og.fflow.shape)
    _H, _W = fshape[-2:]
    if _H == H:
        return flows_og
    fflow = flows_og.fflow.reshape(-1, 2, _H, _W)
    bflow = flows_og.bflow.reshape(-1, 2, _H, _W)
    scale = torch.tensor([_W / W, _H / H], dtype=fflow.dtype,
                         device=fflow.device).reshape(1, 2, 1, 1)
    fshape[-2], fshape[-1] = H, W
    out = ConfigDict()
    out.fflow = _interp_bilinear(fflow / scale, H, W).reshape(fshape)
    out.bflow = _interp_bilinear(bflow / scale, H, W).reshape(fshape)
    return out
