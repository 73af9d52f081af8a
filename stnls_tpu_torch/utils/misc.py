"""Misc utilities (PyTorch port of stnls_tpu/utils/misc.py, the
reference's utils/misc.py): offset <-> absolute coordinate conversion,
reflection, seeding, pickling."""

import pickle
import random

import numpy as np
import torch

from stnls_tpu_torch.utils.config import optional, optional_delete  # noqa: F401
from stnls_tpu_torch.ops.geometry import reflect_bounds


def host_array(x, dtype=None):
    """A numpy copy of a tensor (any device) or array-like."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


def set_seed(seed):
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def assert_nonan(tensor):
    assert not bool(torch.isnan(tensor).any())


def rslice(vid, coords):
    if coords is None or len(coords) == 0:
        return vid
    fs, fe, t, l, b, r = [int(c) for c in coords]
    return vid[fs:fe, :, t:b, l:r]


def write_pickle(fn, obj):
    with open(str(fn), "wb") as f:
        pickle.dump(obj, f)


def read_pickle(fn):
    with open(str(fn), "rb") as f:
        return pickle.load(f)


def get_space_grid(H, W, dtype=torch.float32, device="cuda"):
    """[1, H, W, 2] grid of (x, y) coordinates."""
    y, x = torch.meshgrid(torch.arange(H, dtype=dtype, device=device),
                          torch.arange(W, dtype=dtype, device=device),
                          indexing="ij")
    return torch.stack((x, y), -1)[None]


def reflect_inds(inds, H, W):
    """Reflect absolute (t,h,w) coordinates into frame bounds."""
    h = reflect_bounds(inds[..., 1], H)
    w = reflect_bounds(inds[..., 2], W)
    return torch.cat([inds[..., :1], h[..., None], w[..., None]], -1)


def _grid_and_steps(x, stride0):
    """The (h, w) query grid [1,1,nH,nW,1,2] and the frame index
    [1,T,1,1,1] of offsets or coordinates x [N,T,nH,nW,K,3]."""
    _, T, nH, nW, _, _ = x.shape
    grid = stride0 * get_space_grid(nH, nW, x.dtype, x.device)
    # the grid stores (x, y); offsets are (h, w)
    hw = grid[:, None, :, :, None].flip(-1)
    t = torch.arange(T, dtype=x.dtype, device=x.device).reshape(1, T, 1, 1, 1)
    return hw, t


def _convert(x, stride0, sign):
    ndim = x.ndim
    lead = x.shape[:2]
    if ndim == 7:
        x = x.reshape((lead[0] * lead[1],) + tuple(x.shape[2:]))
    hw, t = _grid_and_steps(x, stride0)
    out = torch.cat([(x[..., 0] + sign * t)[..., None],
                     x[..., 1:] + sign * hw], -1)
    if ndim == 7:
        out = out.reshape(tuple(lead) + tuple(out.shape[1:]))
    return out


def flow2inds(flow, stride0):
    """Relative offsets -> absolute (t,h,w) coordinates
    (reference misc.py:67-83). flow [B(,HD),T,nH,nW,K,3]."""
    return _convert(flow, stride0, 1)


def inds2flow(inds, stride0):
    """Absolute (t,h,w) coordinates -> relative offsets
    (reference misc.py:85-103)."""
    return _convert(inds, stride0, -1)
