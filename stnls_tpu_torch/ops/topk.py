"""Top-K selection over the flattened search volume (PyTorch port of
stnls_tpu/ops/topk.py).

The order is a stable sort: ties go to the lower index, as `lax.top_k`
puts them (torch.topk makes no such promise). Gathers carry the gradient
back into the selected dists.

Layout: offset components on a leading [C, ..., S] axis, as in the JAX
package.
"""

import torch


def _take(inds3, order):
    """inds3 [C, ..., S] at order [..., k] -> [C, ..., k]."""
    idx = order[None].expand((inds3.shape[0],) + order.shape)
    return torch.gather(inds3, -1, idx)


def standard_topk(dists, inds3, k, descending):
    """dists [..., S], inds3 [C, ..., S] -> top-k along the search axis.

    Returns (dists_k, inds3_k, order) with order [..., k] int32; k <= 0
    keeps all S entries, sorted."""
    S = dists.shape[-1]
    k = min(k, S) if k > 0 else S
    order = torch.sort(dists, dim=-1, descending=descending,
                       stable=True)[1][..., :k]
    return (torch.gather(dists, -1, order), _take(inds3, order),
            order.to(torch.int32))


def anchored_topk(dists, inds3, k, descending):
    """Keep slot 0 fixed, top-(k-1) over the rest."""
    dk, ik, order = standard_topk(dists[..., 1:], inds3[..., 1:],
                                  k - 1 if k > 0 else -1, descending)
    return (torch.cat([dists[..., :1], dk], dim=-1),
            torch.cat([inds3[..., :1], ik], dim=-1),
            torch.cat([torch.zeros_like(order[..., :1]), order + 1], dim=-1))


def topk(dists, inds3, k, descending, anchor=False, return_order=False):
    """Menu dispatch; k <= 0 returns the inputs unchanged."""
    if k <= 0:
        return (dists, inds3, None) if return_order else (dists, inds3)
    fn = anchored_topk if anchor else standard_topk
    out = fn(dists, inds3, k, descending)
    return out if return_order else out[:2]


def topk_each(dists, inds3, k, descending, anchor_self=False):
    """Per-group top-k: dists [..., G, S], inds3 [C, ..., G, S] -> top-k
    within each group; with anchor_self slot 0 of each group stays."""
    if k <= 0:
        return dists, inds3
    if anchor_self:
        d0, i0 = dists[..., :1], inds3[..., :1]
        if k > 1 and dists.shape[-1] > 1:
            dk, ik, _ = standard_topk(dists[..., 1:], inds3[..., 1:], k - 1,
                                      descending)
            return torch.cat([d0, dk], dim=-1), torch.cat([i0, ik], dim=-1)
        return d0, i0
    dk, ik, _ = standard_topk(dists, inds3, k, descending)
    return dk, ik


def apply_topk(tensor, order, axis=-1):
    """Permute `tensor` along `axis` by a previously returned order."""
    if order is None:
        return tensor
    return torch.gather(tensor, axis, order.long())
