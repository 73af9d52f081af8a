"""Index masks over videos (PyTorch port of stnls_tpu/utils/mask.py: the
reference's utils/mask.py is an empty stub; this turns search offsets
into a boolean mask over the video pixels they touch).

mask.shape = [T, H, W]
"""

import numpy as np
import torch

from stnls_tpu_torch.ops.geometry import reflect_bounds, put_dropped


def inds_mask(inds, T, H, W, stride0=1):
    """Boolean [T,H,W] mask of pixels referenced by search offsets, on
    the offsets' device.

    inds: [..., T, nH, nW, K, 3] relative (dt,dh,dw) offsets from the
    stride0 query grid (the search output contract). Marks each
    (t+dt, h+dh, w+dw) target pixel, reflect-bounded.
    """
    inds = torch.round(torch.as_tensor(inds).float()).to(torch.int64)
    inds = inds.reshape((-1,) + tuple(inds.shape[-5:]))
    _, T_, nH, nW, K, _ = inds.shape
    dev = inds.device
    t = torch.arange(T_, device=dev)[None, :, None, None, None]
    h = (torch.arange(nH, device=dev) * stride0)[None, None, :, None, None]
    w = (torch.arange(nW, device=dev) * stride0)[None, None, None, :, None]
    nt = reflect_bounds(t + inds[..., 0], T)
    nh = reflect_bounds(h + inds[..., 1], H)
    nw = reflect_bounds(w + inds[..., 2], W)
    flat = (nt * H + nh) * W + nw
    mask = torch.zeros(T * H * W, dtype=torch.bool, device=dev)
    flat = flat.reshape(-1)
    mask = put_dropped(mask, (flat,), torch.ones_like(flat, dtype=torch.bool),
                       (T * H * W,))
    return mask.reshape(T, H, W)


def mask_to_coords(mask):
    """[T,H,W] bool -> [N,3] int coordinates of set pixels (numpy)."""
    mask = mask.cpu().numpy() if isinstance(mask, torch.Tensor) else mask
    return np.argwhere(np.asarray(mask)).astype(np.int32)
