"""Reference-convention anchoring wrappers (PyTorch port of
stnls_tpu/nn/anchor_self.py).

The reference mutates dists/inds in place; here the functions are pure and
return the reordered (dists, inds, order). Offsets use the public
trailing-component convention [..., 3]. anchor_self_refine and
anchor_self_paired wait for the refine search (ROADMAP A10)."""

import torch

from stnls_tpu_torch.ops import anchor as _anchor


def anchor_self(dists, inds, stride0=None, nH=None, nW=None):
    """dists [B,HD,Q,...flatK], inds [..., 2or3] -> (dists, inds, order)."""
    d, i, order = _anchor.anchor_self(dists, torch.movedim(inds, -1, 0))
    return d, torch.movedim(i, 0, -1), order


def anchor_self_time(dists, inds, flows=None, wt=None, stride0=None,
                     qH=None, qW=None, kH=None, kW=None):
    """dists [..., W_t, S], inds [..., W_t, S, 3]."""
    d, i, order = _anchor.anchor_self_time(dists, torch.movedim(inds, -1, 0))
    return d, torch.movedim(i, 0, -1), order
