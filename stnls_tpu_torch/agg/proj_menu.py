"""Projection menu for stack aggregation (PyTorch port of
stnls_tpu/agg/proj_menu.py): a Conv3d over the (K, ps, ps) stack axes.

flax infers the conv's input width; torch takes it at construction:
io_dim * inner_mult channels (the stack's HD * F), io_dim = embed_dim *
nheads, so `init` needs embed_dim, nheads and, for v1, inner_mult.
"""

import torch
import torch.nn.functional as F_

from stnls_tpu_torch.utils.config import extract_pairs, optional


class StackProj(torch.nn.Module):
    """Conv3d [io_dim*inner_mult -> io_dim] over (k_agg, ps, ps), stride
    (k_agg,1,1), zero padding (0, ps//2, ps//2) — the "v1" projection; "v2"
    parameterises kernel and stride — then dropout and the mean over the
    K' axis: [BT, C, K, H, W] -> [BT, io_dim, 1, H, W]."""

    def __init__(self, io_dim, inner_mult=1, k_agg=-1, ps=3, ngroups=1,
                 drop_rate=0.0, ksizes=None, strides=None):
        super().__init__()
        if io_dim <= 0 or inner_mult <= 0:
            raise ValueError(
                "StackProj needs the stack's width: give embed_dim, nheads "
                f"and inner_mult (got io_dim {io_dim}, inner_mult "
                f"{inner_mult})")
        k = tuple(ksizes or (max(k_agg, 1), ps, ps))
        s = tuple(strides or (max(k_agg, 1), 1, 1))
        self.conv = torch.nn.Conv3d(io_dim * inner_mult, io_dim, k, stride=s,
                                    padding=(0, k[1] // 2, k[2] // 2),
                                    groups=ngroups)
        self.drop_rate = drop_rate

    def forward(self, stack, deterministic=True):
        x = self.conv(stack)
        x = F_.dropout(x, self.drop_rate, training=not deterministic)
        return x.mean(dim=2, keepdim=True)


def get_defaults(version):
    if version == "v1":
        return {"ps": -1, "embed_dim": -1, "inner_mult": -1, "k_agg": -1,
                "nheads": -1, "attn_drop_rate_proj": 0.}
    if version == "v2":
        return {"attn_proj_ksize": -1, "attn_proj_stride": "k_ps_ps",
                "attn_proj_ngroups": "ngroups", "attn_drop_rate_proj": 0.}
    raise ValueError(f"Unknown projection version [{version}]")


def extract_config(_cfg, restrict=True):
    version = optional(_cfg, "nlstack_proj_version", "v1")
    defaults = get_defaults(version)
    defaults["nlstack_proj_version"] = version
    return extract_pairs(_cfg, defaults, restrict=restrict)


def _parse(spec, kagg, ps):
    """"k_ps_ps"-style tokens: k -> k_agg, ps -> ps, ps//2 -> ps // 2,
    else an integer (as the JAX parser, a token whose value is 0 is read
    as an integer)."""
    return tuple({"k": kagg, "ps": ps, "ps//2": ps // 2}.get(tok, None)
                 or int(tok) for tok in spec.split("_"))


def init(cfg):
    cfg = extract_config(cfg, False)
    io_dim = cfg.embed_dim * cfg.nheads
    version = cfg.nlstack_proj_version
    if version == "v1":
        return StackProj(io_dim=io_dim, inner_mult=cfg.inner_mult,
                         k_agg=cfg.k_agg, ps=cfg.ps, ngroups=cfg.nheads,
                         drop_rate=cfg.attn_drop_rate_proj)
    if version == "v2":
        kagg = optional(cfg, "k_agg", 1)
        ps = optional(cfg, "ps", 3)
        ks = _parse(cfg.attn_proj_ksize, kagg, ps)
        st = _parse(cfg.attn_proj_stride, kagg, ps)
        ng = cfg.nheads if cfg.attn_proj_ngroups == "nheads" else \
            int(cfg.attn_proj_ngroups)
        return StackProj(io_dim=io_dim, inner_mult=optional(cfg, "inner_mult",
                                                            1),
                         ksizes=ks, strides=st, ngroups=ng,
                         drop_rate=cfg.attn_drop_rate_proj)
    raise NotImplementedError(version)
