"""RefineSearch: second-stage refinement around K given per-query offsets
(PyTorch port of stnls_tpu/search/refinement.py).

Re-search a wr x wr lattice (spacing stride1) around each of the Ks given
offsets (optionally filtered to kr of them), anchor each group's entry
closest to its given offset, then top-K.

Two routes, chosen by `refine_route` from the config and the video shape:
  * "sparse" (pt = 1, reflect_bounds, integer dilation, no query offsets,
    frames that fit the recompute's reflect pad): the selection runs the
    plain lattice (ops/nls.refine_search_volume) under no_grad in bands of
    query rows (`SELECT_CELLS`), so that no tensor the size of the whole
    refine volume is alive, then the anchor and the stable top-K. Only the
    K winners are differentiated: their key positions, frames and
    validity come from torch geometry (differentiable in the offsets
    through the reflection), and ops/nls_cuda.search_dists returns the
    selected dists with the search backward kernel (B2) as their
    gradient, as NonLocalSearch's lazy route does;
  * "lattice" (what B2 does not take: pt > 1, reflect_bounds=False,
    off_Hq/off_Wq, fractional dilation, small frames): the whole plain
    lattice with every cell's offsets, differentiated by autograd, as in
    stnls_tpu.
On CPU tensors B2 runs its plain version. The TPU-only knobs (impl,
flow_budget, spread_budget) are accepted and do nothing; stnls_tpu's cvr
engine is not ported. `restricted_radius` is inert, as in stnls_tpu and
the reference's kernels.
"""

import torch

from stnls_tpu_torch.utils.config import extract_pairs
from stnls_tpu_torch.utils.spans import span
from stnls_tpu_torch.ops import anchor as anchor_ops
from stnls_tpu_torch.ops import topk as topk_ops
from stnls_tpu_torch.ops.geometry import (
    reflect_bounds, in_bounds, num_queries, search_offsets,
)
from stnls_tpu_torch.ops.nls import (
    refine_search_volume, dist_type_select, _expand_flow_heads, INVALID_IND,
)
from stnls_tpu_torch.ops.nls_cuda import search_dists
from stnls_tpu_torch.search.utils import shape_vids, filter_k

# A band of the sparse route's selection holds at most this many (query,
# cell) entries: each of the lattice's patch taps makes a few tensors of
# this many x F floats
SELECT_CELLS = 1 << 24


def refine_route(cfg, vid0_shape, vid1_shape):
    """"sparse" (select in row bands, differentiate the K winners through
    B2) or "lattice" (the whole plain lattice under autograd)."""
    H, W = vid0_shape[-2:]
    sparse = (cfg["pt"] == 1 and cfg["reflect_bounds"]
              and cfg["off_Hq"] == 0 and cfg["off_Wq"] == 0
              and float(cfg["dilation"]).is_integer()
              and tuple(vid0_shape[-2:]) == tuple(vid1_shape[-2:])
              and int(cfg["dilation"]) * (cfg["ps"] - 1) + 2 <= min(H, W) - 1)
    return "sparse" if sparse else "lattice"


def _volume_kw(cfg):
    return dict(ws=cfg["ws"], wr=cfg["wr"], ps=cfg["ps"],
                stride0=cfg["stride0"], stride1=cfg["stride1"],
                dist_type=cfg["dist_type"], dilation=cfg["dilation"],
                pt=cfg["pt"], reflect_bounds_=cfg["reflect_bounds"],
                full_ws=cfg["full_ws"], use_adj=cfg["use_adj"],
                off_Hq=cfg["off_Hq"], off_Wq=cfg["off_Wq"],
                itype=cfg["itype"],
                restricted_radius=cfg["restricted_radius"])


def _anchor_flag(cfg):
    if cfg["self_action"] not in (None, "anchor", "anchor_self",
                                  "anchor_each"):
        raise ValueError(f"Unknown self_action [{cfg['self_action']}]")
    return cfg["self_action"] is not None


def _menu(dists, inds, flows_k, cfg):
    """Anchor and top-K of refine volumes. dists [B,HD,T,Ks,wr,wr,nH,nW];
    inds [C, ...same...] (C - 1 trailing components are carried along:
    the sparse route's cell ids); flows_k [B,HDf,T,nH,nW,Ks,3] the given
    offsets. Returns (dists [B,HD,T,nH,nW,K], inds [C,B,HD,T,nH,nW,K])."""
    B, HD, T, Ks, wr, _, nH, nW = dists.shape
    C = inds.shape[0]
    d = dists.permute(0, 1, 2, 6, 7, 3, 4, 5).reshape(B, HD, T, nH, nW, Ks,
                                                      wr * wr)
    i = inds.permute(0, 1, 2, 3, 7, 8, 4, 5, 6).reshape(C, B, HD, T, nH, nW,
                                                        Ks, wr * wr)
    anchor = _anchor_flag(cfg)
    if anchor:
        fk = flows_k.movedim(-1, 0).to(i.dtype)
        d, i3, self_idx = anchor_ops.anchor_self_refine(d, i[:3], fk)
        if C > 3:
            rest = i[3:]
            idx = self_idx[None, ..., None].long().expand(
                rest.shape[:-1] + (1,))
            slot0 = torch.gather(rest, -1, idx)
            _, rest, _ = anchor_ops._swap_self(d, rest, self_idx.long(),
                                               slot0)
            i3 = torch.cat([i3, rest], dim=0)
        i = i3
    _, descending, _ = dist_type_select(cfg["dist_type"])
    k = cfg["k"]
    if cfg["topk_mode"] == "all":
        d, i = topk_ops.topk(d.flatten(-2), i.flatten(-2), k, descending,
                             anchor=anchor)
    elif cfg["topk_mode"] == "each":
        d, i = topk_ops.topk_each(d, i, k, descending, anchor_self=anchor)
        d, i = d.flatten(-2), i.flatten(-2)
    else:
        raise ValueError(f"Unknown topk_mode [{cfg['topk_mode']}]")
    return d, i


def _lattice_route(vid0, vid1, flows_k, cfg):
    """The whole plain lattice, its anchor and top-K, under autograd."""
    dists, inds3 = refine_search_volume(vid0, vid1, flows_k,
                                        **_volume_kw(cfg))
    d, i = _menu(dists, inds3, flows_k, cfg)
    return d, i.movedim(0, -1)


def select_winners(vid0, vid1, flows_k, cfg, select_cells=None):
    """The sparse route's selection, under no_grad: the plain lattice in
    bands of query rows (of at most `select_cells` entries, default
    SELECT_CELLS), each band's anchor and top-K. Returns (dists
    [B,HD,T,nH,nW,K], cells [B,HD,T,nH,nW,K] flat ids g*wr*wr + wi*wr + wj
    into the groups' lattices, int64)."""
    B, HD, T, F, H, W = vid0.shape
    nH, nW = num_queries(H, W, cfg["stride0"])
    Ks, wr = flows_k.shape[-2], cfg["wr"]
    per_row = B * HD * T * nW * Ks * wr * wr
    rows = max(1, (select_cells or SELECT_CELLS) // per_row)
    ids = torch.arange(Ks * wr * wr, device=vid0.device).reshape(
        Ks, wr, wr)[:, :, :, None, None]
    d_out, c_out = [], []
    with torch.no_grad():
        for r0 in range(0, nH, rows):
            band = slice(r0, min(r0 + rows, nH))
            dists, inds3 = refine_search_volume(
                vid0, vid1, flows_k, rows=band, **_volume_kw(cfg))
            cells = ids.to(inds3.dtype).expand(dists.shape)[None]
            d, i = _menu(dists, torch.cat([inds3, cells], dim=0),
                         flows_k[:, :, :, band], cfg)
            d_out.append(d)
            c_out.append(i[3].long())
            del dists, inds3, cells, d, i
    return torch.cat(d_out, dim=3), torch.cat(c_out, dim=3)


def winners_geometry(flows_k, cells, *, H, W, wr, stride0, stride1,
                     full_ws=True, itype="float"):
    """Geometry of the selected refine cells, with no video reads.

    flows_k [B,HDf,T,nH,nW,Ks,3] the given offsets (dt, dh, dw); cells
    [B,HD,T,nH,nW,K] flat ids of `select_winners` (no grad). Returns a
    dict of [B,HD,T,nH,nW,K] tensors: the key positions prop_h, prop_w
    (float, differentiable in the offsets in the float path), the key
    frame tj_k, `valid` (inside the frame, given offset not the -1e8
    fill) and the offsets dt, dh, dw relative to the query grid (-1e8 for
    a skipped given offset; int32 in the int path)."""
    B, HD, T, nH, nW, K = cells.shape
    dev = cells.device
    is_int = itype == "int"
    stride1 = max(1, int(stride1)) if is_int else float(stride1)
    S = wr * wr
    g = cells // S
    wi = (cells % S) // wr
    wj = cells % wr
    fk = _expand_flow_heads(flows_k, HD)
    fk = torch.gather(fk, 5, g[..., None].expand(g.shape + (3,)))
    if is_int:
        fk = torch.round(fk.detach())
        dt = fk[..., 0].long()
    else:
        dt = torch.floor(fk[..., 0].detach() + 0.5).long()
    t_ids = torch.arange(T, device=dev)[:, None, None, None]
    ref_h = ((torch.arange(nH, device=dev) * stride0) % H)[:, None, None]
    ref_w = ((torch.arange(nW, device=dev) * stride0) % W)[:, None]
    ctr_t = reflect_bounds(t_ids + dt, T)
    ctr_h = reflect_bounds(ref_h + fk[..., 1], H)
    ctr_w = reflect_bounds(ref_w + fk[..., 2], W)
    off_h, off_w = search_offsets(
        ctr_h.detach().to(torch.int32) if is_int else ctr_h.detach(),
        ctr_w.detach().to(torch.int32) if is_int else ctr_w.detach(),
        stride1, wr, H, W, full_ws, is_int)
    prop_h = ctr_h + stride1 * (wi - off_h).to(ctr_h.dtype)
    prop_w = ctr_w + stride1 * (wj - off_w).to(ctr_w.dtype)
    edge = (fk[..., 1].abs() < 1e8) & (fk[..., 2].abs() < 1e8)
    valid = in_bounds(prop_h, H) & in_bounds(prop_w, W) & edge
    odt = torch.int32 if is_int else torch.float32
    fill = torch.tensor(-100000000 if is_int else INVALID_IND, dtype=odt,
                        device=dev)
    offs = [x.to(odt) for x in (ctr_t - t_ids, prop_h - ref_h,
                                prop_w - ref_w)]
    dt_o, dh, dw = (torch.where(edge, x, fill) for x in offs)
    return dict(prop_h=prop_h.float(), prop_w=prop_w.float(), tj_k=ctr_t,
                valid=valid, dt=dt_o, dh=dh, dw=dw)


def _sparse_route(vid0, vid1, flows_k, cfg):
    """Select the K winners under no_grad, then their dists with B2 as
    the gradient and their offsets, differentiable in the offsets."""
    H, W = vid0.shape[-2:]
    d_sel, cells = select_winners(vid0.detach(), vid1.detach(),
                                  flows_k.detach(), cfg)
    geo = winners_geometry(flows_k, cells, H=H, W=W, wr=cfg["wr"],
                           stride0=cfg["stride0"], stride1=cfg["stride1"],
                           full_ws=cfg["full_ws"], itype=cfg["itype"])
    d = search_dists(vid0, vid1, geo["prop_h"], geo["prop_w"], d_sel,
                     geo["tj_k"], geo["valid"], ps=cfg["ps"],
                     stride0=cfg["stride0"], dist_type=cfg["dist_type"],
                     dilation=int(cfg["dilation"]), use_adj=cfg["use_adj"],
                     itype=cfg["itype"])
    return d, torch.stack([geo["dt"], geo["dh"], geo["dw"]], dim=-1)


def refine_pipeline(vid0, vid1, flows_k, cfg):
    """vid0/vid1 [B,HD,T,F,H,W]; flows_k [B,HDf,T,nH,nW,Ks,3] -> (dists
    [B,HD,T,nH,nW,K], inds [B,HD,T,nH,nW,K,3]), by `refine_route`."""
    if refine_route(cfg, vid0.shape, vid1.shape) == "sparse":
        return _sparse_route(vid0, vid1, flows_k, cfg)
    return _lattice_route(vid0, vid1, flows_k, cfg)


class RefineSearch(torch.nn.Module):
    """search = RefineSearch(ws, wt, wr, k, kr, ps, ...);
    dists, inds = search(vid0, vid1, flows) with flows
    [B,HD,T,nH,nW,K,3] (or [B,HD,Q,K,3]) relative offsets."""

    def __init__(self, ws, wt, wr, k, kr=-1, ps=1, nheads=1, stride0=4,
                 stride1=1, dilation=1, pt=1, dist_type="l2",
                 restricted_radius=False, reflect_bounds=True, full_ws=True,
                 self_action=None, use_adj=False, normalize_bwd=False,
                 k_agg=-1, topk_mode="all", off_Hq=0, off_Wq=0,
                 itype="float", impl="auto", flow_budget=8,
                 spread_budget=8):
        super().__init__()
        self.cfg = dict(
            ws=ws, wt=wt, wr=wr, k=k, kr=kr, ps=ps, nheads=nheads,
            stride0=stride0, stride1=stride1, dilation=dilation, pt=pt,
            dist_type=dist_type, restricted_radius=restricted_radius,
            reflect_bounds=reflect_bounds, full_ws=full_ws,
            self_action=self_action, use_adj=use_adj,
            normalize_bwd=normalize_bwd, k_agg=k_agg, topk_mode=topk_mode,
            off_Hq=off_Hq, off_Wq=off_Wq, itype=itype, impl=impl,
            flow_budget=flow_budget, spread_budget=spread_budget)
        for key, val in self.cfg.items():
            setattr(self, key, val)

    def forward(self, vid0, vid1, flows):
        with span("stnls.search.refine"):
            vid0, vid1 = shape_vids(self.nheads, [vid0, vid1])
            B, HD, T, F, H, W = vid0.shape
            nH, nW = num_queries(H, W, self.stride0)
            if flows.ndim == 5:  # [B,HD,Q,K,3]
                flows = flows.reshape(flows.shape[0], flows.shape[1], T, nH,
                                      nW, flows.shape[-2], 3)
            flows = filter_k(flows, self.kr)
            return refine_pipeline(vid0, vid1, flows, self.cfg)

    def paired_vids(self, vid0, vid1, flows, wt, skip_self=False):
        from stnls_tpu_torch.search.utils import paired_vids
        return paired_vids(self.forward, vid0, vid1, flows, wt, skip_self)

    def flops(self, T, F, H, W):
        nrefs = T * ((H - 1) // self.stride0 + 1) \
            * ((W - 1) // self.stride0 + 1)
        nsearch = self.wr * self.wr * max(self.k, 1)
        return nrefs * nsearch * 2 * F * self.ps * self.ps * self.pt

    def radius(self, *args):
        return self.wr


def _apply(vid0, vid1, flows, ws, wt, wr, k, kr=-1, ps=1, nheads=1,
           stride0=4, stride1=1, dilation=1, pt=1, dist_type="l2",
           restricted_radius=False, reflect_bounds=True, full_ws=True,
           self_action=None, use_adj=False, normalize_bwd=False, k_agg=-1,
           topk_mode="all", off_Hq=0, off_Wq=0, itype="float"):
    """Functional API: stnls_tpu_torch.search.refine(...)."""
    search = RefineSearch(ws, wt, wr, k, kr, ps, nheads, stride0, stride1,
                          dilation, pt, dist_type, restricted_radius,
                          reflect_bounds, full_ws, self_action, use_adj,
                          normalize_bwd, k_agg, topk_mode, off_Hq, off_Wq,
                          itype)
    return search(vid0, vid1, flows)


def extract_config(cfg, restrict=True):
    pairs = {"ws": -1, "wt": -1, "wr": 1, "kr": -1, "ps": 1, "k": -1,
             "nheads": 1, "dist_type": "l2",
             "stride0": 4, "stride1": 1, "dilation": 1, "pt": 1,
             "restricted_radius": False,
             "reflect_bounds": True, "full_ws": True,
             "self_action": None, "use_adj": False,
             "normalize_bwd": False, "k_agg": -1, "topk_mode": "all",
             "off_Hq": 0, "off_Wq": 0, "itype": "float",
             "impl": "auto", "flow_budget": 8, "spread_budget": 8}
    return extract_pairs(cfg, pairs, restrict=restrict)


def init(cfg):
    cfg = extract_config(cfg, False)
    return RefineSearch(cfg.ws, cfg.wt, cfg.wr, cfg.k, cfg.kr, cfg.ps,
                        cfg.nheads, cfg.stride0, cfg.stride1, cfg.dilation,
                        cfg.pt, cfg.dist_type, cfg.restricted_radius,
                        cfg.reflect_bounds, cfg.full_ws, cfg.self_action,
                        cfg.use_adj, cfg.normalize_bwd, cfg.k_agg,
                        cfg.topk_mode, cfg.off_Hq, cfg.off_Wq, cfg.itype,
                        cfg.impl, cfg.flow_budget, cfg.spread_budget)
