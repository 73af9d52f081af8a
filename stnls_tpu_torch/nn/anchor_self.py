"""Reference-convention anchoring wrappers (PyTorch port of
stnls_tpu/nn/anchor_self.py).

The reference mutates dists/inds in place; here the functions are pure and
return the reordered (dists, inds, order). Offsets use the public
trailing-component convention [..., 3] ([..., 2] for the paired
searches)."""

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


def anchor_self_refine(dists, inds, flows, stride0=None, qH=None, qW=None,
                       kH=None, kW=None):
    """dists [..., Ks, S], inds [..., Ks, S, 3], flows [..., Ks, 3]."""
    d, i, order = _anchor.anchor_self_refine(
        dists, torch.movedim(inds, -1, 0), torch.movedim(flows, -1, 0))
    return d, torch.movedim(i, 0, -1), order


def anchor_self_paired(dists, inds, flows, stride0=None, qH=None, qW=None,
                       kH=None, kW=None):
    """The 2-d variant: inds [..., Ks, S, 2], flows [..., Ks, 2]."""
    return anchor_self_refine(dists, inds, flows)
