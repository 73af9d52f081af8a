"""The attention step that bench.py, __graft_entry__.entry and
examples/attn_example.py run, in PyTorch.

q, k, v = 1x1 projections (einsum with proj_w [F,F]) -> search_flow ->
NonLocalSearch -> softmax(-10 * dists) -> NonLocalGather -> K-mixing
projection (einsum with stack_w [K,F,F]). `smooth_flows` is bench.py's
smooth random flow field, from a numpy Generator.
"""

import numpy as np
import torch

from stnls_tpu_torch.nn.flow import search_flow
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
