"""The attention step that bench.py, __graft_entry__.entry and
examples/attn_example.py run, in PyTorch.

q, k, v = 1x1 projections (einsum with proj_w [F,F]) -> search_flow ->
NonLocalSearch -> softmax(-10 * dists) -> NonLocalGather -> K-mixing
projection (einsum with stack_w [K,F,F]). `smooth_flows` is bench.py's
smooth random flow field, from a numpy Generator. `attention_module` is
NonLocalAttention at the same search config with seeded weights, and
`cuda_ms` the one step timer; chip_smoke.py and profile_step.py drive
both. `VOLUME_SEARCH` is the search of the volume path's slice: per-frame
top-2 with each frame's self cell anchored (K = W_t * k = 10, the same K
as the bench step), which runs the full-volume kernels B5/B6.
"""

import numpy as np
import torch

from stnls_tpu_torch.nn.flow import search_flow
from stnls_tpu_torch.nn.non_local_attn import NonLocalAttention
from stnls_tpu_torch.search.non_local_search import NonLocalSearch
from stnls_tpu_torch.agg.gather import NonLocalGather


def smooth_flows(rng, shape, amp=4.0, modes=4):
    """Low-frequency random flow fields [B,T,2,H,W], |flow| <= ~amp."""
    B, T, _, H, W = shape
    y = np.linspace(0, 2 * np.pi, H, endpoint=False)
    x = np.linspace(0, 2 * np.pi, W, endpoint=False)
    yy, xx = np.meshgrid(y, x, indexing="ij")
    out = np.zeros(shape, np.float32)
    for b in range(B):
        for t in range(T):
            for c in range(2):
                f = np.zeros((H, W))
                for _ in range(modes):
                    ky, kx = rng.integers(0, 3, 2)
                    ph = rng.uniform(0, 2 * np.pi, 2)
                    f += rng.normal() * np.cos(ky * yy + ph[0]) \
                        * np.cos(kx * xx + ph[1])
                f *= amp / (np.abs(f).max() + 1e-8) * rng.uniform(0.5, 1.0)
                out[b, t, c] = f
    return out


VOLUME_SEARCH = {"self_action": "anchor_each", "topk_mode": "each", "k": 2}


def attention_module(seed, device="cuda", search=None, agg=None,
                     cls=NonLocalAttention, attn=None):
    """NonLocalAttention (2 heads of 8 channels, the bench step's search:
    ws=5, wt=2, ps=3, K=10, stride1=0.5, anchor, float) with weights drawn
    from numpy seed `seed`, scaled by 1/sqrt(fan-in). `search`, `agg`
    and `attn` override entries of the search, agg and attention configs
    (e.g. VOLUME_SEARCH);
    `cls` is the module built from the four configs (e.g.
    NonLocalAttentionStack)."""
    attn_cfg = {"nheads": 2, "embed_dim": 8, "use_attn_projection": True,
                "use_attn_flow": True, **(attn or {})}
    search_cfg = {"search_name": "nls", "ws": 5, "wt": 2, "ps": 3, "k": 10,
                  "nheads": 2, "stride0": 1, "stride1": 0.5,
                  "self_action": "anchor", "itype": "float",
                  "dist_type": "l2", **(search or {})}
    normz_cfg = {"normz_name": "softmax", "normz_scale": 10,
                 "dist_type": "l2"}
    agg_cfg = {"agg_name": "gather", "ps": 3, "stride0": 1,
               "itype": "float", **(agg or {})}
    attn = cls(attn_cfg, search_cfg, normz_cfg, agg_cfg)
    rng = np.random.default_rng(seed)
    state = {}
    for key, val in attn.state_dict().items():
        fan_in = max(1, int(np.prod(val.shape[1:])))
        state[key] = torch.from_numpy(
            (rng.standard_normal(tuple(val.shape)) / np.sqrt(fan_in))
            .astype(np.float32))
    attn.load_state_dict(state)
    return attn.to(device)


def cuda_ms(fn, n=10, warm=2):
    """Median of n CUDA-event times of fn() in ms, after `warm` calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


class AttnStep(torch.nn.Module):
    """forward(vid [B,T,F,H,W], fflow, bflow [B,T,2,H,W], proj_w [F,F],
    stack_w [K,F,F]) -> [B,T,F,H,W]."""

    def __init__(self, ws=5, wt=2, ps=3, k=10, nheads=2, stride0=1,
                 stride1=0.5):
        super().__init__()
        self.wt, self.stride0 = wt, stride0
        self.search = NonLocalSearch(
            ws, wt, ps, k, nheads=nheads, stride0=stride0, stride1=stride1,
            self_action="anchor", itype="float")
        self.gather = NonLocalGather(ps=ps, stride0=stride0)

    def forward(self, vid, fflow, bflow, proj_w, stack_w):
        q = torch.einsum("btchw,cd->btdhw", vid, proj_w)
        k = torch.einsum("btchw,cd->btdhw", vid, proj_w)
        v = torch.einsum("btchw,cd->btdhw", vid, proj_w)
        flows = search_flow(fflow, bflow, self.wt, self.stride0)
        dists, srch_flows = self.search(q, k, flows)
        weights = torch.softmax(-10. * dists, dim=-1)
        stack = self.gather(v, weights, srch_flows)
        B, HD, K, T, F, H, W = stack.shape
        stack = stack.permute(0, 3, 2, 1, 4, 5, 6).reshape(B, T, K, HD * F,
                                                           H, W)
        return torch.einsum("btkchw,kcd->btdhw", stack, stack_w)
