"""Anchor-self reordering (PyTorch port of stnls_tpu/ops/anchor.py).

Moves each query's "self" entry (the one whose offset is ~zero) to slot 0
of the flattened search volume, as a functional permutation built from
argmin and masked selects, differentiable through the dists (and through
float offsets).

Layout: offset components on a leading [3, ..., S] axis, as in the JAX
package.

Semantics:
  * the self entry is the first entry minimizing |dt|+|dh|+|dw|
    (torch.argmin returns the first minimum);
  * dists: slot 0 and the self slot swap values;
  * inds: slot 0 is overwritten with exact zeros, and the *old* slot-0
    offset triple is written into the self slot.
`anchor_self_refine` anchors, in each group of a refine search, the
entry closest to the group's given offset, and keeps that entry's own
offsets in slot 0.
"""

import torch


def _swap_self(dists, inds3, self_idx, slot0_inds):
    """Slot 0 <-> the self slot along the last axis; slot 0's offsets
    become `slot0_inds` [C, ..., 1]."""
    S = dists.shape[-1]
    s_ids = torch.arange(S, device=dists.device)
    is_self = s_ids == self_idx[..., None]
    is_zero = s_ids == 0
    dself = torch.gather(dists, -1, self_idx[..., None])
    new_dists = torch.where(is_zero, dself,
                            torch.where(is_self, dists[..., :1], dists))
    new_inds3 = torch.where(is_zero, slot0_inds,
                            torch.where(is_self, inds3[..., :1], inds3))
    return new_dists, new_inds3, self_idx.to(torch.int32)


def anchor_self(dists, inds3):
    """dists [..., S], inds3 [C, ..., S] -> (dists, inds3, order [...])."""
    delta = torch.sum(torch.abs(inds3), dim=0)
    self_idx = torch.argmin(delta, dim=-1)
    return _swap_self(dists, inds3, self_idx,
                      torch.zeros_like(inds3[..., :1]))


def anchor_self_time(dists, inds3):
    """Per-time-slot anchoring: dists [..., W_t, S], inds3
    [3, ..., W_t, S]; anchors the min |dh|+|dw| entry of each time slot to
    that slot's position 0 while keeping its dt."""
    delta = torch.sum(torch.abs(inds3[1:]), dim=0)   # spatial offset only
    self_idx = torch.argmin(delta, dim=-1)
    idx = self_idx[None, ..., None].expand(inds3.shape[:-1] + (1,))
    iself = torch.gather(inds3, -1, idx)
    # slot 0 keeps the self entry's (dt, 0, 0): spatial components zeroed
    zeroed = torch.cat([iself[:1], torch.zeros_like(iself[1:])], dim=0)
    return _swap_self(dists, inds3, self_idx, zeroed)


def anchor_self_refine(dists, inds3, flows3):
    """Refinement anchoring: per source group, move the entry closest
    (first argmin of the L1 distance) to the group's *given* offset to
    slot 0 of the group. dists [..., Ks, S], inds3 [C, ..., Ks, S], flows3
    [C, ..., Ks]; slot 0 takes the self entry's own offsets."""
    delta = torch.sum(torch.abs(inds3 - flows3[..., None]), dim=0)
    self_idx = torch.argmin(delta, dim=-1)
    idx = self_idx[None, ..., None].expand(inds3.shape[:-1] + (1,))
    return _swap_self(dists, inds3, self_idx, torch.gather(inds3, -1, idx))
