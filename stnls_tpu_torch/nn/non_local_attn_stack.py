"""NonLocalAttentionStack: the attention block whose aggregation is the
NonLocalGather stack (PyTorch port of stnls_tpu/nn/non_local_attn_stack.py).

As the JAX module: menu-dispatched search with the refine-from-state and
rand_inds paths, `ref_itype` mangling for refinement searches, the
recurrent state update, menu-dispatched aggregation, share_kv, and
per-stage timing with attn_timer. Unlike NonLocalAttention, the stack
[B,HD,K,T,F,H,W] is mixed by a 1x1 conv over its K*HD*F channels
(`stack_proj`) before the output projection. The stages and the state are
NonLocalAttention's; this class changes the qkv (share_kv) and the
projection.

flax infers `stack_proj`'s input width from the stack; torch builds it
from the config: K*HD*F channels for a gather stack (K = k_agg where set,
else the search's k; F = embed_dim * inner_mult), HD*F for an aggregator
that returns a video [B,HD,T,F,H,W] (e.g. gather_add).
"""

import contextlib
import time

import torch

from stnls_tpu_torch.utils import config
from stnls_tpu_torch.utils.config import optional
from stnls_tpu_torch.utils.spans import span
from stnls_tpu_torch.nn.non_local_attn import NonLocalAttention, \
    default_pairs
from stnls_tpu_torch.agg.gather import NonLocalGather


def extract_config(cfg, restrict=True):
    pairs = dict(default_pairs())
    pairs.update({"share_kv": False, "ref_itype": None,
                  "ps_stack": 7, "k_agg": -1})
    return config.extract_pairs(cfg, pairs, restrict=restrict)


class NonLocalAttentionStack(NonLocalAttention):
    """attn = NonLocalAttentionStack(attn_cfg, search_cfg, normz_cfg,
    agg_cfg); vid_out, state = attn(vid, flows, state)."""
    refine_names = ("ref", "refine")

    def __init__(self, attn_cfg, search_cfg, normz_cfg, agg_cfg):
        attn_cfg = extract_config(attn_cfg, restrict=False)
        # refinement searches may run another index type than the
        # first-stage search
        search_cfg = dict(search_cfg)
        ref_itype = optional(attn_cfg, "ref_itype",
                             optional(search_cfg, "ref_itype", None))
        if optional(search_cfg, "search_name", "nls") in self.refine_names \
                and ref_itype is not None:
            search_cfg["itype"] = ref_itype
        super().__init__(dict(attn_cfg, use_attn_projection=True),
                         search_cfg, normz_cfg, agg_cfg)
        self.share_kv = attn_cfg.share_kv
        self.k_agg = optional(search_cfg, "k_agg", -1)
        k_eff = self.k_agg if self.k_agg > 0 else optional(search_cfg, "k", 1)
        self.proj_k = max(int(k_eff), 1)
        head_dim = attn_cfg.embed_dim * optional(attn_cfg, "inner_mult", 1)
        slots = self.proj_k if isinstance(self.agg, NonLocalGather) else 1
        self.stack_proj = torch.nn.Conv2d(
            slots * attn_cfg.nheads * head_dim, self.dim, 1)

    def get_qkv(self, vid):
        q, k, v = super().get_qkv(vid)
        return q, k, (k if self.share_kv else v)

    def run_projection(self, stack, deterministic=True):
        return self.run_stack_projection(stack)

    def run_stack_projection(self, stack):
        """Stack [B,HD,K,T,F,H,W] -> the 1x1 mix of its (K, HD, F)
        channels (`stack_proj`) -> the 1x1 output projection; a video
        [B,HD,T,F,H,W] mixes its (HD, F) channels."""
        if stack.ndim == 6:     # the aggregator produced a video
            B, HD, T, F, H, W = stack.shape
            x = stack.permute(0, 2, 1, 3, 4, 5).reshape(B * T, HD * F, H, W)
        else:
            B, HD, K, T, F, H, W = stack.shape
            x = stack.permute(0, 3, 2, 1, 4, 5, 6).reshape(B * T,
                                                           K * HD * F, H, W)
        x = self.proj(self.stack_proj(x))
        return x.reshape(B, T, self.dim, H, W)


class _StageTimer:
    """Per-stage spans, and timing honouring attn_timer. Each stage runs
    under the span `stnls.attn.<name>` (utils/spans, the counterpart of
    jax.named_scope), so that profiler traces carry the stage. Enabled
    (and not under torch.compile), each stage's wall time in seconds also
    goes into `times` under its bare name; on a CUDA tensor the device is
    synchronised before each clock read, else the times would be those of
    the launches only."""

    def __init__(self, enabled, probe):
        self.eager = enabled and not torch.compiler.is_compiling()
        self.device = probe.device if probe.is_cuda else None
        self.times = {}

    def _sync(self):
        if self.device is not None:
            torch.cuda.synchronize(self.device)

    def __call__(self, name):
        if not self.eager:
            return span(f"stnls.attn.{name}")

        @contextlib.contextmanager
        def timed():
            with span(f"stnls.attn.{name}"):
                self._sync()
                t0 = time.perf_counter()
                yield
                self._sync()
                self.times[name] = time.perf_counter() - t0
        return timed()
