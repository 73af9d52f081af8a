"""Padding helpers (PyTorch port of stnls_tpu/utils/pads.py).

jnp.pad takes any rank and any pad width; torch.nn.functional.pad's
reflect takes 3-5-D input and a pad below the padded dim. same_padded
pads the last two dims of any rank by index maps that follow numpy's
modes (reflect repeats its reflection for a pad beyond the dim).
"""

import torch
import torch.nn.functional as nnf


def comp_pads(vshape, ps, stride, dil):
    """Padded size + offsets for a ps/stride/dil patch grid over (H, W)."""
    H, W = vshape[-2:]
    pad = dil * (ps // 2)
    Hp, Wp = H + 2 * pad, W + 2 * pad
    nH = (Hp - dil * (ps - 1) - 1) // stride + 1
    nW = (Wp - dil * (ps - 1) - 1) // stride + 1
    return Hp, Wp, nH, nW


def _pad_index(L, pad, mode, device):
    """Source index along one axis of length L for each of L + 2 * pad
    padded positions, as numpy.pad's `mode`."""
    i = torch.arange(-pad, L + pad, device=device)
    if mode == "reflect":
        period = max(2 * (L - 1), 1)
        m = i % period
        return torch.where(m >= L, period - m, m)
    if mode == "symmetric":
        m = i % (2 * L)
        return torch.where(m >= L, 2 * L - 1 - m, m)
    if mode == "edge":
        return i.clamp(0, L - 1)
    if mode == "wrap":
        return i % L
    raise ValueError(f"same_padded: unknown mode {mode!r}")


def same_padded(vid, ps, stride=1, dil=1, mode="reflect"):
    """Pad the last two dims by dil*(ps//2) (numpy.pad modes "reflect",
    "symmetric", "edge", "wrap" and "constant")."""
    pad = dil * (ps // 2)
    if mode == "constant":
        return nnf.pad(vid, (pad, pad, pad, pad))
    H, W = vid.shape[-2:]
    ih = _pad_index(H, pad, mode, vid.device)
    iw = _pad_index(W, pad, mode, vid.device)
    return vid.index_select(-2, ih).index_select(-1, iw)
