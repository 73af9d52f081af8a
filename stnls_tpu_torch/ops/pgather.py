"""Shared patch-gather primitive (PyTorch port of stnls_tpu/ops/pgather.py).

`patch_gather(frames, (tj, oi, oj), (S, Tp, Hp, Wp))` fetches, for every
query in an arbitrary index tail, the S x S block of integer pixels whose
top-left corner is (oi, oj) in frame tj, for all C channels at once.
Plain indexing: torch autograd's index backward replaces the TPU custom
VJP (on CUDA it accumulates with atomics, so gradients are not bitwise
deterministic).
"""

import torch
import torch.nn.functional as F_


def patch_gather(frames, idx3, dims):
    """frames [B,HD,C,M] flat (M = Tp*Hp*Wp); idx3 = (tj, oi, oj) int
    tensors [B,HD,*tail]; dims = (S, Tp, Hp, Wp) static.
    Returns P [B,HD,C,S,S,*tail]."""
    S, Tp, Hp, Wp = dims
    tj, oi, oj = idx3
    B, HD, C, M = frames.shape
    dev = frames.device
    tail = tj.shape[2:]
    nt = len(tail)
    base = (tj.long() * Hp + oi.long()) * Wp + oj.long()     # [B,HD,*tail]
    u_off = (torch.arange(S, device=dev) * Wp)[:, None] \
        + torch.arange(S, device=dev)[None, :]
    u_off = u_off.reshape((1, 1, S, S) + (1,) * nt)
    bh = (torch.arange(B * HD, device=dev) * M).reshape((B, HD, 1, 1)
                                                        + (1,) * nt)
    # clip (not fill): coordinates from invalid cells are weight-masked by
    # the caller and must stay finite
    idx = (base[:, :, None, None] + u_off).clamp(0, M - 1) + bh
    rows = frames.transpose(2, 3).reshape(B * HD * M, C)
    return rows[idx].movedim(-1, 2)


def pad_frames_cf(vid, pad, mode="reflect"):
    """vid [B,HD,T,F,H,W] -> (flat padded channels-first [B,HD,F,M],
    (T, Hp, Wp)). Reflect padding makes every reflected read an in-bounds
    read of the padded frame, so patch_gather needs no per-pixel
    reflect/clip."""
    B, HD, T, F, H, W = vid.shape
    vp = F_.pad(vid.reshape(B * HD * T, F, H, W), (pad, pad, pad, pad),
                mode=mode)
    Hp, Wp = H + 2 * pad, W + 2 * pad
    vp = vp.reshape(B, HD, T, F, Hp * Wp).transpose(2, 3) \
        .reshape(B, HD, F, T * Hp * Wp)
    return vp, (T, Hp, Wp)
