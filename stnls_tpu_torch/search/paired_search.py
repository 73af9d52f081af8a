"""PairedSearch: single-frame-pair search (PyTorch port of
stnls_tpu/search/paired_search.py).

Searches a ws x ws lattice in frame1 around flow-shifted centres of
frame0's query grid; 2-d offsets (dh, dw) out. It is the T = 1, wt = 0
NonLocalSearch with frame1 as the key frame, and the building block of
the frame-streaming search `paired_vids`. With no self_action and k > 0
it takes NonLocalSearch's lazy route where that route takes the config
(the search kernel B1 selects, B2 is the backward); otherwise the whole
volume (B5/B6, or the plain lattice for what they do not take), then the
paired anchor (the entry closest to the given flow, whose components are
flipped to (dh, dw)) and the stable top-K. stnls_tpu's cvr engine is not
ported; its knobs are accepted and do nothing.
"""

import torch

from stnls_tpu_torch.utils.config import extract_pairs
from stnls_tpu_torch.ops import anchor as anchor_ops
from stnls_tpu_torch.ops import topk as topk_ops
from stnls_tpu_torch.ops.nls import dist_type_select, _expand_flow_heads
from stnls_tpu_torch.search.non_local_search import (
    nls_pipeline, search_route, volume_with_inds,
)
from stnls_tpu_torch.search.utils import paired_vids as _paired_vids


def _shape_frames(nheads, frames):
    """[B,C,H,W] -> [B,HD,F,H,W]; 5-d frames pass."""
    out = []
    for f in frames:
        if f.ndim not in (4, 5):
            raise ValueError("frames must be 4 or 5 dims")
        if f.ndim == 4:
            B, C, H, W = f.shape
            if C % nheads:
                raise ValueError("channels must divide nheads")
            f = f.reshape(B, nheads, C // nheads, H, W)
        out.append(f)
    return out


def _nls_cfg(cfg):
    """The NonLocalSearch config the paired search is: T = 1, wt = 0."""
    return dict(ws=cfg["ws"], wt=0, ps=cfg["ps"], k=cfg["k"],
                stride0=cfg["stride0"], stride1=cfg["stride1"],
                dist_type=cfg["dist_type"], dilation=cfg["dilation"], pt=1,
                self_action=None, topk_mode="all", ws_interior=0,
                reflect_bounds=cfg["reflect_bounds"],
                full_ws=cfg["full_ws"], use_adj=cfg["use_adj"],
                off_Hq=cfg["off_Hq"], off_Wq=cfg["off_Wq"], strideQ=None,
                itype=cfg["itype"])


def paired_pipeline(frame0, frame1, flow, cfg):
    """frame0/frame1 [B,HD,F,H,W]; flow [B,HDf,2,nH,nW] (channel 0 = w)
    -> (dists [B,HD,nH,nW,K], inds [B,HD,nH,nW,K,2])."""
    vid0, vid1 = frame0[:, :, None], frame1[:, :, None]     # T = 1
    flows = flow[:, :, None, None]            # [B,HDf,T=1,W_t=1,2,nH,nW]
    ncfg = _nls_cfg(cfg)
    if cfg["self_action"] is not None and "anchor" not in cfg["self_action"]:
        raise ValueError(f"Unknown self_action [{cfg['self_action']}]")
    anchor = cfg["self_action"] is not None
    if not anchor and cfg["k"] > 0 \
            and search_route(ncfg, vid0.shape) == "topk":
        d, inds = nls_pipeline(vid0, vid1, flows, ncfg)
        return d[:, :, 0], inds[:, :, 0, ..., 1:]
    dists, inds3 = volume_with_inds(vid0, vid1, flows, ncfg)
    # [B,HD,1,1,ws,ws,nH,nW] -> [B,HD,nH,nW,ws*ws], offsets (dh, dw)
    B, HD, _, _, ws, _, nH, nW = dists.shape
    dists = dists[:, :, 0, 0].permute(0, 1, 4, 5, 2, 3).reshape(
        B, HD, nH, nW, ws * ws)
    inds2 = inds3[1:, :, :, 0, 0].permute(0, 1, 2, 5, 6, 3, 4).reshape(
        2, B, HD, nH, nW, ws * ws)
    if anchor:
        fl = _expand_flow_heads(flow, HD)
        fk = torch.stack([fl[:, :, 1], fl[:, :, 0]], 0)[..., None]
        d, i2, _ = anchor_ops.anchor_self_refine(
            dists[..., None, :], inds2[..., None, :], fk.to(inds2.dtype))
        dists, inds2 = d[..., 0, :], i2[..., 0, :]
    _, descending, _ = dist_type_select(cfg["dist_type"])
    if cfg["k"] > 0:
        dists, inds2 = topk_ops.topk(dists, inds2, cfg["k"], descending,
                                     anchor=anchor)
    return dists, inds2.movedim(0, -1)


class PairedSearch(torch.nn.Module):
    """dists, inds = search(frame0, frame1, flow); frames [B,(HD),C,H,W],
    flow [B,(HD),2,nH,nW]; inds [B,HD,nH,nW,K,2]."""

    def __init__(self, ws, ps=1, k=-1, nheads=1, dist_type="l2", stride0=4,
                 stride1=1, dilation=1, pt=1, reflect_bounds=True,
                 full_ws=True, self_action=None, use_adj=False,
                 normalize_bwd=False, k_agg=-1, off_Hq=0, off_Wq=0,
                 itype="float", impl="auto", flow_budget="auto",
                 spread_budget=8):
        super().__init__()
        self.cfg = dict(
            ws=ws, ps=ps, k=k, nheads=nheads, dist_type=dist_type,
            stride0=stride0, stride1=stride1, dilation=dilation, pt=pt,
            reflect_bounds=reflect_bounds, full_ws=full_ws,
            self_action=self_action, use_adj=use_adj,
            normalize_bwd=normalize_bwd, k_agg=k_agg, off_Hq=off_Hq,
            off_Wq=off_Wq, itype=itype, impl=impl,
            flow_budget=flow_budget, spread_budget=spread_budget)
        for key, val in self.cfg.items():
            setattr(self, key, val)

    def forward(self, frame0, frame1, flow):
        if self.ws <= 0:
            raise ValueError("Must have nonzero spatial search window")
        frame0, frame1 = _shape_frames(self.nheads, [frame0, frame1])
        if flow.ndim == 4:
            flow = flow[:, None]
        return paired_pipeline(frame0, frame1, flow, self.cfg)

    def paired_vids(self, vid0, vid1, flows, wt, skip_self=False):
        return _paired_vids(self.forward, vid0, vid1, flows, wt, skip_self)

    def flops(self, T, F, H, W):
        nrefs = ((H - 1) // self.stride0 + 1) * ((W - 1) // self.stride0 + 1)
        return nrefs * self.ws * self.ws * 2 * F * self.ps * self.ps

    def radius(self, *args):
        return self.ws


def _apply(frame0, frame1, flow, ws, ps=1, k=-1, nheads=1, dist_type="l2",
           stride0=4, stride1=1, dilation=1, pt=1, reflect_bounds=True,
           full_ws=True, self_action=None, use_adj=False,
           normalize_bwd=False, k_agg=-1, off_Hq=0, off_Wq=0, itype="float"):
    """Functional API: stnls_tpu_torch.search.paired_search(...)."""
    search = PairedSearch(ws, ps, k, nheads, dist_type, stride0, stride1,
                          dilation, pt, reflect_bounds, full_ws, self_action,
                          use_adj, normalize_bwd, k_agg, off_Hq, off_Wq,
                          itype)
    return search(frame0, frame1, flow)


def extract_config(cfg, restrict=True):
    pairs = {"ws": -1, "ps": 1, "k": -1,
             "nheads": 1, "dist_type": "l2",
             "stride0": 4, "stride1": 1, "dilation": 1, "pt": 1,
             "reflect_bounds": True, "full_ws": True,
             "self_action": None, "use_adj": False,
             "normalize_bwd": False, "k_agg": -1,
             "off_Hq": 0, "off_Wq": 0, "itype": "float",
             "impl": "auto", "flow_budget": "auto", "spread_budget": 8}
    return extract_pairs(cfg, pairs, restrict=restrict)


def init(cfg):
    cfg = extract_config(cfg, False)
    return PairedSearch(cfg.ws, cfg.ps, cfg.k, cfg.nheads, cfg.dist_type,
                        cfg.stride0, cfg.stride1, cfg.dilation, cfg.pt,
                        cfg.reflect_bounds, cfg.full_ws, cfg.self_action,
                        cfg.use_adj, cfg.normalize_bwd, cfg.k_agg,
                        cfg.off_Hq, cfg.off_Wq, cfg.itype, cfg.impl,
                        cfg.flow_budget, cfg.spread_budget)
