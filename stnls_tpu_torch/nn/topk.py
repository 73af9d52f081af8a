"""Reference-convention top-K wrappers (PyTorch port of
stnls_tpu/nn/topk.py). Offsets use the public trailing-component layout
[..., D]."""

import torch

from stnls_tpu_torch.ops import topk as _topk


def topk(dists, inds, k, dim=None, anchor=False, descending=True,
         unique=False, return_order=False):
    """Top-k along the search axis (always the axis before the component
    axis of inds). `unique` is accepted for the reference's signature:
    the deterministic lattice has no duplicates to remove."""
    del dim, unique
    d, i, order = _topk.topk(dists, torch.movedim(inds, -1, 0), k,
                             descending, anchor=anchor, return_order=True)
    i = torch.movedim(i, 0, -1)
    if return_order:
        return d, i, order
    return d, i


def topk_each(dists, inds, k, descending, anchor_self=False):
    d, i = _topk.topk_each(dists, torch.movedim(inds, -1, 0), k, descending,
                           anchor_self=anchor_self)
    return d, torch.movedim(i, 0, -1)


def standard_topk(dists, inds, k, descending):
    d, i, order = _topk.standard_topk(dists, torch.movedim(inds, -1, 0), k,
                                      descending)
    return d, torch.movedim(i, 0, -1), order


def anchored_topk(dists, inds, k, descending, unique=False):
    del unique
    d, i, order = _topk.anchored_topk(dists, torch.movedim(inds, -1, 0), k,
                                      descending)
    return d, torch.movedim(i, 0, -1), order


def apply_topk(tensor, order, dim):
    return _topk.apply_topk(tensor, order, axis=dim)
