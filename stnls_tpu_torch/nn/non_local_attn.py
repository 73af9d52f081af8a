"""NonLocalAttention: the composite search -> normalise -> aggregate block
(PyTorch port of stnls_tpu/nn/non_local_attn.py).

ConvQKV 1x1 projections (reflect padding for larger kernels),
menu-dispatched search (a refinement search consumes the recurrent
`state`), softmax normalisation, menu-dispatched aggregation and an output
1x1 projection, as torch.nn.Modules. The recurrent `state` is threaded
through the call as in the JAX module. Each of the five stages (qkv,
search, normz, agg, proj) runs under a `_StageTimer`
(nn/non_local_attn_stack.py): the span `stnls.attn.<stage>`, and with
attn_timer its wall time in `module._times` too.
`params_from_jax` (stnls_tpu_torch.convert) carries flax parameters over.
"""

import torch
import torch.nn.functional as F_

from stnls_tpu_torch.utils import config
from stnls_tpu_torch.utils.config import optional
from stnls_tpu_torch.nn.utils import rescale_flows
from stnls_tpu_torch import search as search_mod
from stnls_tpu_torch import normz as normz_mod
from stnls_tpu_torch import agg as agg_mod


def default_pairs():
    return {"nheads": 1, "inner_mult": 1,
            "embed_dim": 16,
            "qk_frac": 1., "qkv_bias": True,
            "qkv_ngroups": 1,
            "use_attn_projection": True,
            "drop_rate_proj": 0.,
            "attn_timer": False, "use_attn_flow": True,
            "use_norm_layer": False}


def extract_config(cfg, restrict=True):
    return config.extract_pairs(cfg, default_pairs(), restrict=restrict)


class LayerNorm2D(torch.nn.Module):
    """Channel layernorm on [B,T,C,H,W] (flax LayerNorm epsilon)."""

    def __init__(self, dim):
        super().__init__()
        self.norm = torch.nn.LayerNorm(dim, eps=1e-6)

    def forward(self, vid):
        return self.norm(vid.movedim(2, -1)).movedim(-1, 2)


class ConvQKV(torch.nn.Module):
    """1x1 (or kxk reflect-padded) convs producing q, k, v on [N,C,H,W]."""

    def __init__(self, input_dim, heads=8, dim_head=64, qk_frac=1.,
                 kernel_size=1, bias=True, ngroups=1):
        super().__init__()
        inner_dim = dim_head * heads
        inner_dim_qk = max(int(qk_frac * dim_head), 1) * heads
        self.kernel_size = kernel_size

        def conv(out_dim):
            return torch.nn.Conv2d(input_dim, out_dim, kernel_size,
                                   groups=ngroups, bias=bias)

        self.to_q = conv(inner_dim_qk)
        self.to_k = conv(inner_dim_qk)
        self.to_v = conv(inner_dim)

    def forward(self, x, attn_kv=None):
        attn_kv = x if attn_kv is None else attn_kv
        pad = (self.kernel_size - 1) // 2

        def run(conv, z):
            if pad > 0:
                z = F_.pad(z, (pad, pad, pad, pad), mode="reflect")
            return conv(z)

        return run(self.to_q, x), run(self.to_k, attn_kv), \
            run(self.to_v, attn_kv)


class NonLocalAttention(torch.nn.Module):
    """attn = NonLocalAttention(attn_cfg, search_cfg, normz_cfg, agg_cfg);
    vid_out, state = attn(vid, flows, state)."""
    refine_names = ("refine",)

    def __init__(self, attn_cfg, search_cfg, normz_cfg, agg_cfg):
        super().__init__()
        attn_cfg = extract_config(attn_cfg, restrict=False)
        nheads = attn_cfg.nheads
        inner_mult = optional(attn_cfg, "inner_mult", 1)
        embed_dim = attn_cfg.embed_dim * inner_mult
        io_dim = attn_cfg.embed_dim * nheads
        self.dim = io_dim
        self.search_cfg = search_cfg

        self.search = search_mod.init(search_cfg)
        self.normz = normz_mod.init(normz_cfg)
        self.agg = agg_mod.init(agg_cfg)

        self.use_flow = attn_cfg.use_attn_flow
        self.use_timer = attn_cfg.attn_timer
        self.use_state_update = optional(search_cfg, "use_state_update",
                                         False)
        self.search_name = optional(search_cfg, "search_name", "nls")
        self.stride0 = optional(search_cfg, "stride0", 1)

        self.qkv = ConvQKV(io_dim, heads=nheads, dim_head=embed_dim,
                           qk_frac=attn_cfg.qk_frac, bias=attn_cfg.qkv_bias,
                           ngroups=attn_cfg.qkv_ngroups)
        self.proj = torch.nn.Conv2d(io_dim, io_dim, 1) \
            if attn_cfg.use_attn_projection else None
        self.norm_layer = LayerNorm2D(io_dim) \
            if attn_cfg.use_norm_layer else None

    def forward(self, vid, flows=None, state=None, deterministic=True):
        from stnls_tpu_torch.nn.non_local_attn_stack import _StageTimer
        timer = _StageTimer(self.use_timer, vid)
        B, T, C, H, W = vid.shape
        if self.use_flow and flows is not None:
            flows = rescale_flows(flows, H, W)
        if self.norm_layer is not None:
            vid = self.norm_layer(vid)
        with timer("qkv"):
            q_vid, k_vid, v_vid = self.get_qkv(vid)
        with timer("search"):
            dists, inds = self.run_search(q_vid, k_vid, flows, state)
        state = self._next_state(state, inds, q_vid.shape)
        # as the JAX module: the attention weights are never dropped
        with timer("normz"):
            weights, inds = self.normz(dists, inds)
        with timer("agg"):
            vid = self.run_aggregation(v_vid, weights, inds)
        with timer("proj"):
            vid = self.run_projection(vid, deterministic)
        self._times = timer.times
        return vid, state

    def get_qkv(self, vid):
        B, T, C, H, W = vid.shape
        q, k, v = self.qkv(vid.reshape(B * T, C, H, W))
        return (q.reshape(B, T, -1, H, W), k.reshape(B, T, -1, H, W),
                v.reshape(B, T, -1, H, W))

    def run_search(self, q_vid, k_vid, flows, state):
        """The flow search; a refinement search starts from the previous
        call's offsets (state[0]) and rand_inds takes no flows. The search
        menu raises NotImplementedError for these two until they are
        ported."""
        if self.search_name in self.refine_names:
            return self.search(q_vid, k_vid, _inds_rs1(state[0]))
        if self.search_name == "rand_inds":
            return self.search(q_vid, k_vid)
        return self.search(q_vid, k_vid, flows.fflow, flows.bflow)

    def _next_state(self, state, inds, vshape):
        if not self.use_state_update or state is None:
            return state
        H, W = vshape[-2:]
        nH = (H - 1) // self.stride0 + 1
        nW = (W - 1) // self.stride0 + 1
        return [_inds_rs0(inds.detach(), nH, nW), state[0]]

    def run_aggregation(self, v_vid, weights, inds):
        return self.agg(v_vid, weights, inds)

    def run_projection(self, vid, deterministic=True):
        """The output projection; `deterministic` is accepted as in the
        JAX module, which drops nothing there either."""
        if self.proj is None:
            return vid
        if vid.ndim == 7:  # [B,HD,K,T,F,H,W] stack from gather
            B, HD, K, T, F, H, W = vid.shape
            vid = vid.mean(dim=2)
            vid = vid.permute(0, 2, 1, 3, 4, 5).reshape(B, T, HD * F, H, W)
        elif vid.ndim == 6:  # [B,HD,T,F,H,W]
            B, HD, T, F, H, W = vid.shape
            vid = vid.permute(0, 2, 1, 3, 4, 5).reshape(B, T, HD * F, H, W)
        B, T, C, H, W = vid.shape
        return self.proj(vid.reshape(B * T, C, H, W)).reshape(B, T, C, H, W)

    def flops(self, H, W):
        """qkv + search + normz + agg + projection, as the JAX module
        counts them (its parts' own flops, where they have them)."""
        nrefs = ((H - 1) // self.stride0 + 1) * ((W - 1) // self.stride0 + 1)
        total = 3 * H * W * self.dim * self.dim       # the q, k, v 1x1 convs
        if hasattr(self.search, "flops"):
            total += self.search.flops(1, self.dim, H, W)
        if hasattr(self.normz, "flops"):
            total += self.normz.flops()
        k = optional(self.search_cfg, "k", 10)
        nheads = optional(self.search_cfg, "nheads", 1)
        if hasattr(self.agg, "flops"):
            total += self.agg.flops(nrefs, self.dim // max(nheads, 1),
                                    nheads, max(k, 1))
        total += nrefs * self.dim * self.dim
        return total


def _inds_rs0(inds, nH, nW):
    """[B,HD,Q,K,3] or [B,HD,T,nH,nW,K,3] -> state layout
    [T,nH,nW,B,HD,K,3]."""
    if inds.ndim == 5:
        B, HD, Q, K, tr = inds.shape
        inds = inds.reshape(B, HD, Q // (nH * nW), nH, nW, K, tr)
    elif inds.ndim != 7:
        return inds
    return inds.permute(2, 3, 4, 0, 1, 5, 6)


def _inds_rs1(inds):
    """State layout [T,nH,nW,B,HD,K,3] -> [B,HD,Q,K,3]."""
    if inds.ndim != 7:
        return inds
    T, nH, nW, B, HD, K, tr = inds.shape
    inds = inds.permute(3, 4, 0, 1, 2, 5, 6)
    return inds.reshape(B, HD, T * nH * nW, K, tr)
