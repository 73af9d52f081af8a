"""RGB <-> orthonormal-YUV conversion (PyTorch port of
stnls_tpu/utils/color.py).

Functional, as the JAX module: each function returns a new tensor and
never writes into its input. The colour axis is dimension -3.
"""

import numpy as np
import torch

_W3 = float(1. / np.sqrt(3))
_W2 = float(1. / np.sqrt(2))
_W23 = float(np.sqrt(2.) / np.sqrt(3))


def rgb2gray(burst):
    """[..., 3, H, W] -> [..., 1, H, W] luma."""
    w = torch.tensor([0.2989, 0.5870, 0.1140], dtype=burst.dtype,
                     device=burst.device)
    return (burst.movedim(-3, -1) @ w)[..., None, :, :]


def rgb2yuv(burst):
    """[..., 3, H, W] RGB -> orthonormal YUV."""
    r, g, b = burst[..., 0, :, :], burst[..., 1, :, :], burst[..., 2, :, :]
    y = _W3 * (r + g + b)
    u = _W2 * (r - b)
    v = (_W23 * 2.) * (.25 * r - 0.5 * g + .25 * b)
    return torch.stack([y, u, v], dim=-3)


def yuv2rgb(burst):
    """Orthonormal YUV -> RGB (inverse of rgb2yuv)."""
    y, u, v = burst[..., 0, :, :], burst[..., 1, :, :], burst[..., 2, :, :]
    r = _W3 * y + _W2 * u + _W23 * 0.5 * v
    g = _W3 * y - _W23 * v
    b = _W3 * y - _W2 * u + _W23 * 0.5 * v
    return torch.stack([r, g, b], dim=-3)


def yuv2rgb_patches(patches):
    """[b, k, pt, c, ph, pw] patch layout wrapper."""
    return yuv2rgb(patches)
