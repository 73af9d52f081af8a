"""PairedRefine: the refinement variant of the paired search (PyTorch port
of stnls_tpu/search/paired_refine.py): a wr x wr lattice around each of
the K given 2-d offsets of a single frame pair. It is the RefineSearch at
T = 1 on offsets lifted to 3-d with dt = 0 (search.refinement's routes:
the selection in row bands and B2 for the winners' gradient, or the
plain lattice), the 2-d offsets (dh, dw) out. stnls_tpu's cvr engine is
not ported; its knobs are accepted and do nothing.
"""

import torch

from stnls_tpu_torch.utils.config import extract_pairs
from stnls_tpu_torch.search.refinement import refine_pipeline
from stnls_tpu_torch.search.utils import filter_k, paired_vids_refine
from stnls_tpu_torch.search.paired_search import _shape_frames


def paired_refine_pipeline(frame0, frame1, flows_k, cfg):
    """frame0/frame1 [B,HD,F,H,W]; flows_k [B,HD,nH,nW,K,2] or
    [B,HD,Q,K,2] (dh, dw) -> (dists [B,HD,nH,nW,K'], inds
    [B,HD,nH,nW,K',2])."""
    B, HD, F, qH, qW = frame0.shape
    nH = (qH - 1) // cfg["stride0"] + 1
    nW = (qW - 1) // cfg["stride0"] + 1
    K2 = flows_k.shape[-2]
    fk = flows_k.reshape(B, HD, 1, nH, nW, K2, 2)
    fk3 = torch.cat([torch.zeros_like(fk[..., :1]), fk], dim=-1)
    d, inds = refine_pipeline(frame0[:, :, None], frame1[:, :, None], fk3,
                              dict(cfg, pt=1))
    return d[:, :, 0], inds[:, :, 0, ..., 1:]


class PairedRefine(torch.nn.Module):
    """dists, inds = search(frame0, frame1, flows_k); frames
    [B,(HD),C,H,W], flows_k [B,HD,nH,nW,K,2] (or [B,HD,Q,K,2])."""

    def __init__(self, ws, wr, k, kr=-1, ps=1, nheads=1, dist_type="l2",
                 stride0=4, stride1=1, dilation=1, pt=1,
                 reflect_bounds=True, full_ws=True, self_action=None,
                 use_adj=False, normalize_bwd=False, k_agg=-1,
                 topk_mode="all", off_Hq=0, off_Wq=0, itype="float",
                 impl="auto", flow_budget=8, spread_budget=8):
        super().__init__()
        self.cfg = dict(
            ws=ws, wr=wr, k=k, kr=kr, ps=ps, nheads=nheads,
            dist_type=dist_type, stride0=stride0, stride1=stride1,
            dilation=dilation, pt=pt, reflect_bounds=reflect_bounds,
            full_ws=full_ws, self_action=self_action, use_adj=use_adj,
            normalize_bwd=normalize_bwd, k_agg=k_agg, topk_mode=topk_mode,
            off_Hq=off_Hq, off_Wq=off_Wq, itype=itype, impl=impl,
            flow_budget=flow_budget, spread_budget=spread_budget,
            restricted_radius=False)
        for key, val in self.cfg.items():
            setattr(self, key, val)

    def forward(self, frame0, frame1, flows_k):
        if self.wr <= 0:
            raise ValueError("Must have nonzero refinement window")
        frame0, frame1 = _shape_frames(self.nheads, [frame0, frame1])
        flows_k = filter_k(flows_k, self.kr)
        return paired_refine_pipeline(frame0, frame1, flows_k, self.cfg)

    def paired_vids(self, vid0, vid1, flows, wt, skip_self=False):
        return paired_vids_refine(self.forward, vid0, vid1, flows, wt,
                                  skip_self)

    def flops(self, T, F, H, W):
        nrefs = ((H - 1) // self.stride0 + 1) * ((W - 1) // self.stride0 + 1)
        return nrefs * self.wr * self.wr * 2 * F * self.ps * self.ps

    def radius(self, *args):
        return self.wr


def _apply(frame0, frame1, flows_k, ws, wr, k, kr=-1, ps=1, nheads=1,
           dist_type="l2", stride0=4, stride1=1, dilation=1, pt=1,
           reflect_bounds=True, full_ws=True, self_action=None,
           use_adj=False, normalize_bwd=False, k_agg=-1, topk_mode="all",
           off_Hq=0, off_Wq=0, itype="float"):
    """Functional API: stnls_tpu_torch.search.paired_refine(...)."""
    search = PairedRefine(ws, wr, k, kr, ps, nheads, dist_type, stride0,
                          stride1, dilation, pt, reflect_bounds, full_ws,
                          self_action, use_adj, normalize_bwd, k_agg,
                          topk_mode, off_Hq, off_Wq, itype)
    return search(frame0, frame1, flows_k)


def extract_config(cfg, restrict=True):
    pairs = {"ws": -1, "wr": 1, "kr": -1, "ps": 1, "k": -1,
             "nheads": 1, "dist_type": "l2",
             "stride0": 4, "stride1": 1, "dilation": 1, "pt": 1,
             "reflect_bounds": True, "full_ws": True,
             "self_action": None, "use_adj": False,
             "normalize_bwd": False, "k_agg": -1, "topk_mode": "all",
             "off_Hq": 0, "off_Wq": 0, "itype": "float",
             "impl": "auto", "flow_budget": 8, "spread_budget": 8}
    return extract_pairs(cfg, pairs, restrict=restrict)


def init(cfg):
    cfg = extract_config(cfg, False)
    return PairedRefine(cfg.ws, cfg.wr, cfg.k, cfg.kr, cfg.ps, cfg.nheads,
                        cfg.dist_type, cfg.stride0, cfg.stride1,
                        cfg.dilation, cfg.pt, cfg.reflect_bounds,
                        cfg.full_ws, cfg.self_action, cfg.use_adj,
                        cfg.normalize_bwd, cfg.k_agg, cfg.topk_mode,
                        cfg.off_Hq, cfg.off_Wq, cfg.itype)
