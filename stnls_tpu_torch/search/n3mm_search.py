"""N3MatMultSearch: the matmul-based search (PyTorch port of
stnls_tpu/search/n3mm_search.py, after N3Net's indexed batched matmul).

Builds the patch database of both videos, lays out the absolute search
grid with nn.non_local_inds, and evaluates the distances as an indexed
batched product: a gather and torch.einsum, as stnls_tpu computes it
outside any kernel. The offsets it returns are the grid's absolute
(t, h, w) coordinates, rounded, as stnls_tpu's are. It serves as an
independent check of NonLocalSearch.
"""

import torch

from stnls_tpu_torch.utils.config import extract_pairs
from stnls_tpu_torch.ops.geometry import reflect_bounds as reflect, \
    in_bounds, num_queries
from stnls_tpu_torch.ops.nls import dist_type_select
from stnls_tpu_torch.ops import topk as topk_ops
from stnls_tpu_torch.nn.non_local_inds import non_local_inds


def vid2patches(vid, nheads, stride, ps, dilation=1, reflect_bounds=True):
    """[B,T,(HD F),H,W] -> [(B HD), Q, ps*ps*F] patch database: the ps x ps
    patch of every stride-grid pixel, reflected at the borders (0 outside
    the frame with reflect_bounds=False). `dilation` is accepted and
    unused, as in stnls_tpu."""
    B, T, C, H, W = vid.shape
    F = C // nheads
    vid6 = vid.reshape(B, T, nheads, F, H, W).permute(0, 2, 1, 3, 4, 5)
    nH, nW = num_queries(H, W, stride)
    dev = vid.device
    hs = torch.arange(nH, device=dev) * stride
    ws_ = torch.arange(nW, device=dev) * stride
    off = -(ps // 2)
    pats = []
    for pi in range(ps):
        for pj in range(ps):
            h = hs + pi + off
            w = ws_ + pj + off
            if reflect_bounds:
                h, w = reflect(h, H), reflect(w, W)
            ok = in_bounds(h, H)[:, None] & in_bounds(w, W)[None, :]
            p = vid6[..., h.clamp(0, H - 1), :][..., w.clamp(0, W - 1)]
            pats.append(p * ok.to(vid.dtype))        # [B,HD,T,F,nH,nW]
    pat = torch.stack(pats, dim=3)                  # [B,HD,T,P2,F,nH,nW]
    B_, HD, T_, P2, F_, nH_, nW_ = pat.shape
    return pat.permute(0, 1, 2, 5, 6, 3, 4).reshape(
        B_ * HD, T_ * nH_ * nW_, P2 * F_)


def n3mm_fwd(vid0, vid1, fflow, bflow, cfg):
    """vid0/vid1 [B,T,(HD F),H,W]; fflow/bflow [B,T,2,H,W] -> (dists
    [B,HD,T,nH,nW,K], inds [B,HD,T,nH,nW,K,3] absolute int32)."""
    nheads = cfg["nheads"]
    ws, wt, ps = cfg["ws"], cfg["wt"], cfg["ps"]
    stride0, stride1 = cfg["stride0"], cfg["stride1"]
    B, T, C, H, W = vid0.shape
    nH0, nW0 = num_queries(H, W, stride0)
    Q = T * nH0 * nW0
    s1 = int(max(1, stride1))

    # absolute float coords of the search grid -> int raster
    inds = non_local_inds(fflow, bflow, ws, wt, stride0, stride1)
    inds = torch.round(inds).to(torch.int32).reshape(B, Q, -1, 3)
    L = inds.shape[2]

    pat0 = vid2patches(vid0, nheads, stride0, ps, cfg["dilation"],
                       cfg["reflect_bounds"])          # [(B HD), Q, E]
    pat1 = vid2patches(vid1, nheads, s1, ps, cfg["dilation"],
                       cfg["reflect_bounds"])
    nH1, nW1 = num_queries(H, W, s1)
    ind = inds.long()
    r = (ind[..., 0] * nH1 + ind[..., 1] // s1) * nW1 + ind[..., 2] // s1
    r = r.repeat_interleave(nheads, dim=0)             # [(B HD), Q, L]

    # indexed batched product: prods[b,q,l] = <pat0[b,q], pat1[b, r[b,q,l]]>
    E = pat0.shape[-1]
    BH = r.shape[0]
    p1 = torch.gather(pat1, 1, r.reshape(BH, Q * L, 1).expand(BH, Q * L, E))
    p1 = p1.reshape(BH, Q, L, E)
    prods = torch.einsum("bqe,bqle->bql", pat0, p1)
    if cfg["dist_type"] == "prod":
        dists = prods
    else:
        n0 = torch.sum(pat0 ** 2, -1)[..., None]
        n1 = torch.sum(p1 ** 2, -1)
        dists = n0 + n1 - 2 * prods

    dists = dists.reshape(B, nheads, Q, L)
    inds = inds[:, None].expand(B, nheads, Q, L, 3)
    _, descending, _ = dist_type_select(cfg["dist_type"])
    if cfg["k"] > 0:
        dists, i3 = topk_ops.topk(dists, inds.movedim(-1, 0), cfg["k"],
                                  descending)
        inds = i3.movedim(0, -1)
    dists = dists.reshape(B, nheads, T, nH0, nW0, -1)
    inds = inds.reshape(B, nheads, T, nH0, nW0, -1, 3)
    return dists, inds


class N3MatMultSearch(torch.nn.Module):
    """dists, inds = search(vid0, vid1[, fflow, bflow]); zero flows when
    none are given."""

    def __init__(self, ws, wt, ps=1, k=-1, nheads=1, dist_type="l2",
                 stride0=1, stride1=1, dilation=1, pt=1,
                 reflect_bounds=True, full_ws=True, use_adj=False,
                 itype="int"):
        super().__init__()
        self.cfg = dict(ws=ws, wt=wt, ps=ps, k=k, nheads=nheads,
                        dist_type=dist_type, stride0=stride0,
                        stride1=stride1, dilation=dilation, pt=pt,
                        reflect_bounds=reflect_bounds, full_ws=full_ws,
                        use_adj=use_adj, itype=itype)
        for key, val in self.cfg.items():
            setattr(self, key, val)

    def forward(self, vid0, vid1, fflow=None, bflow=None):
        B, T, C, H, W = vid0.shape
        zero = torch.zeros((B, T, 2, H, W), dtype=vid0.dtype,
                           device=vid0.device)
        fflow = zero if fflow is None else fflow
        bflow = zero if bflow is None else bflow
        return n3mm_fwd(vid0, vid1, fflow, bflow, self.cfg)

    def flops(self, T, F, H, W):
        nrefs = T * ((H - 1) // self.stride0 + 1) \
            * ((W - 1) // self.stride0 + 1)
        nsearch = self.ws * self.ws * (2 * self.wt + 1)
        return nrefs * nsearch * 2 * F * self.ps * self.ps


def extract_config(cfg, restrict=True):
    pairs = {"ws": -1, "wt": -1, "ps": 1, "k": -1,
             "nheads": 1, "dist_type": "l2",
             "stride0": 1, "stride1": 1, "dilation": 1, "pt": 1,
             "reflect_bounds": True, "full_ws": True,
             "use_adj": False, "itype": "int"}
    return extract_pairs(cfg, pairs, restrict=restrict)


def init(cfg):
    cfg = extract_config(cfg, False)
    return N3MatMultSearch(cfg.ws, cfg.wt, cfg.ps, cfg.k, cfg.nheads,
                           cfg.dist_type, cfg.stride0, cfg.stride1,
                           cfg.dilation, cfg.pt, cfg.reflect_bounds,
                           cfg.full_ws, cfg.use_adj, cfg.itype)
