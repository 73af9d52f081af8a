"""Softmax normalisation of search distances (PyTorch port of
stnls_tpu/normz/softmax.py): optionally truncate to k_agg, negate l2
distances, scale, softmax over K, dropout."""

import torch


class SoftmaxNormalize(torch.nn.Module):

    def __init__(self, scale, drop_rate=0., dist_type="l2", k_agg=-1):
        super().__init__()
        self.scale = scale
        self.drop_rate = drop_rate
        self.dist_type = dist_type
        self.k_agg = k_agg

    def forward(self, dists, inds, *, generator=None, deterministic=True):
        if self.k_agg > 0:
            dists = dists[..., :self.k_agg]
            inds = inds[..., :self.k_agg, :]
        if self.dist_type == "l2":
            dists = -dists
        dists = torch.softmax(self.scale * dists, dim=-1)
        if self.drop_rate > 0 and not deterministic:
            keep = torch.rand(dists.shape, generator=generator,
                              device=dists.device) < 1. - self.drop_rate
            dists = torch.where(keep, dists / (1. - self.drop_rate),
                                torch.zeros_like(dists))
        return dists, inds

    def flops(self, *args):
        return 0


def init(cfg):
    return SoftmaxNormalize(cfg.normz_scale, cfg.normz_drop_rate,
                            cfg.dist_type, cfg.k_agg)
