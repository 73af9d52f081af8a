"""NonLocalDenoiser: the flagship model wiring the full stack (PyTorch
port of stnls_tpu/models/denoiser.py) — conv embedding, flow-guided
NonLocalAttention, residual refinement, conv output.

On CUDA tensors its search and gather run the hand-written kernels B1-B4
(search top-K, its backward, the gather stack, its backward); on CPU
tensors their plain versions.
"""

import torch

from stnls_tpu_torch.models.blocks import ResBlockList, ChannelAttention, \
    _conv2d
from stnls_tpu_torch.nn.non_local_attn import NonLocalAttention


class NonLocalDenoiser(torch.nn.Module):
    """vid [B,T,C,H,W] (+ flows dict) -> (denoised vid [B,T,C,H,W], state).

    C is `in_dim`: flax infers it from the video (and ignores in_dim),
    torch builds the embedding and output convs from it.
    search_overrides / agg_overrides go into the search and agg configs as
    in the JAX module; their TPU tuning knobs (impl, flow_budget,
    spread_budget, band_dtype, agg_budget, agg_spread, wt_hint, ...) are
    accepted there and do nothing."""

    def __init__(self, in_dim=3, embed_dim=16, nheads=2, ws=9, wt=1, ps=3,
                 k=9, stride0=1, nres=2, search_overrides=None,
                 agg_overrides=None):
        super().__init__()
        io_dim = embed_dim * nheads
        attn_cfg = {"nheads": nheads, "embed_dim": embed_dim,
                    "use_attn_projection": True, "use_attn_flow": True}
        search_cfg = {"search_name": "nls", "ws": ws, "wt": wt,
                      "ps": ps, "k": k, "nheads": nheads,
                      "stride0": stride0, "self_action": "anchor",
                      "itype": "float", "dist_type": "l2",
                      **(search_overrides or {})}
        normz_cfg = {"normz_name": "softmax", "normz_scale": 10,
                     "dist_type": "l2"}
        agg_cfg = {"agg_name": "gather", "ps": ps,
                   "stride0": stride0, "itype": "float",
                   **(agg_overrides or {})}
        self.io_dim = io_dim
        self.embed = _conv2d(in_dim, io_dim, 3)
        self.attn = NonLocalAttention(attn_cfg, search_cfg, normz_cfg,
                                      agg_cfg)
        self.res = ResBlockList(nres, io_dim)
        self.chnl = ChannelAttention(io_dim)
        self.out = _conv2d(io_dim, in_dim, 3)

    def forward(self, vid, flows=None, state=None):
        B, T, C, H, W = vid.shape
        io_dim = self.io_dim
        x = self.embed(vid.reshape(B * T, C, H, W)).reshape(B, T, io_dim, H,
                                                            W)
        y, state = self.attn(x, flows, state)
        y = x + y
        z = self.res(y.reshape(B * T, io_dim, H, W))
        z = self.chnl(z)
        out = self.out(z).reshape(B, T, C, H, W)
        return vid + out, state
