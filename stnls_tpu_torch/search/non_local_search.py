"""NonLocalSearch: the centrepiece search op (PyTorch port of
stnls_tpu/search/non_local_search.py).

Two routes, as in the JAX package, chosen by `search_route` from the
config and the video shape alone:
  * lazy top-K (self_action in {None, "anchor", "anchor_self"},
    topk_mode="all", k > 0, grad "auto"/"sparse_k", at most KMAX = 64
    ranked slots): the fused top-K
    kernel (ops/nls_cuda.nls_topk, B1) selects the K winning window cells
    and their distances under no_grad, as the JAX package's TPU route does
    with `nls_pallas_topk`. The cells' key positions and offsets come from
    torch geometry (ops/nls_k.cells_geometry, differentiable in the
    flows), and ops/nls_cuda.search_dists returns B1's distances with the
    K-sparse backward kernel (B2) as their gradient;
  * the full volume (every other self_action and topk_mode, k <= 0,
    grad="dense", more ranked slots than B1 keeps, and frames too small
    for the lazy route's reflect pad):
    the volume kernel (ops/nls_vol_cuda.search_volume, B5, with B6 as its
    backward) at the flows' reflected centres (ops/nls.search_centres),
    the offsets of every cell (ops/nls_k.aux_to_inds3), then the
    self_action and top-K menu `_self_action_topk`, as `nls_pallas_volume`
    and the lattice engine feed it in the JAX package.
On CPU tensors every kernel runs its plain version. `nls_pipeline` also
runs one temporal chunk of a time-sharded search (query_t0, T_global:
ops/nls.chunk_frames), the rank body of stnls_tpu_torch/parallel.

Ported: every self_action and topk_mode, with pt=1, reflect_bounds=True,
no query offsets (strideQ, off_Hq/off_Wq), no ws_interior, integer
dilation, and the k_agg/normalize_bwd gradient policy. Other
configurations raise NotImplementedError. The TPU-only knobs (impl,
flow_budget, spread_budget, cv_tile, qchunk, band_dtype, mx_precision)
are accepted and do nothing: the kernels are exact for any flow.
"""

import numpy as np
import torch

from stnls_tpu_torch.utils.config import extract_pairs
from stnls_tpu_torch.ops import anchor as anchor_ops
from stnls_tpu_torch.ops import topk as topk_ops
from stnls_tpu_torch.ops.nls import dist_type_select
from stnls_tpu_torch.ops.nls_cuda import nls_topk, search_dists, KMAX, \
    ranked_slots
from stnls_tpu_torch.ops.nls_k import cells_geometry, search_aux, aux_to_inds3
from stnls_tpu_torch.ops.nls_vol_cuda import search_volume
from stnls_tpu_torch.search.utils import shape_vids, shape_flows, empty_flows

SELF_ACTIONS = (None, "anchor", "anchor_self", "anchor_each", "remove",
                "remove_ref_frame", "anchor_and_remove_ref_frame")


def _self_action_topk(dists, inds3, *, self_action, topk_mode, k, wt,
                      dist_type):
    """Apply the self_action menu then top-K.

    In: volume layout dists [B,HD,T,W_t,ws,ws,nH,nW], inds3
    [3,B,HD,T,W_t,ws,ws,nH,nW]. Out: reference layout dists
    [B,HD,T,nH,nW,K], inds [B,HD,T,nH,nW,K,3]."""
    B, HD, T, W_t, ws, _, nH, nW = dists.shape
    Q = T * nH * nW
    # queries major, search cells minor: [B,HD,Q,W_t,ws*ws]
    dists = dists.permute(0, 1, 2, 6, 7, 3, 4, 5).reshape(B, HD, Q, W_t,
                                                          ws * ws)
    inds3 = inds3.permute(0, 1, 2, 3, 7, 8, 4, 5, 6).reshape(3, B, HD, Q,
                                                             W_t, ws * ws)
    if self_action not in SELF_ACTIONS:
        raise ValueError(f"Unknown self_action [{self_action}]")
    anchor_flag = self_action is not None and "anchor" in self_action
    if self_action in ("remove_ref_frame", "anchor_and_remove_ref_frame") \
            and wt <= 0:
        raise ValueError("Cannot remove ref frame if not searching across "
                         "time.")

    if self_action in ("anchor", "anchor_self", "remove"):
        d, i, _ = anchor_ops.anchor_self(dists.reshape(B, HD, Q, -1),
                                         inds3.reshape(3, B, HD, Q, -1))
        if self_action == "remove":
            # flattened: groups no longer meaningful
            dists, inds3 = d[..., 1:], i[..., 1:]
        else:
            dists = d.reshape(B, HD, Q, W_t, ws * ws)
            inds3 = i.reshape(3, B, HD, Q, W_t, ws * ws)
    elif self_action == "anchor_each":
        dists, inds3, _ = anchor_ops.anchor_self_time(dists, inds3)
    elif self_action in ("remove_ref_frame", "anchor_and_remove_ref_frame"):
        dists, inds3 = dists[..., 1:, :], inds3[..., 1:, :]
        if self_action == "anchor_and_remove_ref_frame":
            dists, inds3, _ = anchor_ops.anchor_self_time(dists, inds3)

    _, descending, _ = dist_type_select(dist_type)
    if topk_mode == "all":
        dists, inds3 = topk_ops.topk(dists.reshape(B, HD, Q, -1),
                                     inds3.reshape(3, B, HD, Q, -1), k,
                                     descending, anchor=anchor_flag)
    elif topk_mode == "each":
        dists, inds3 = topk_ops.topk_each(dists, inds3, k, descending,
                                          anchor_self=anchor_flag)
    elif topk_mode == "none":
        if k > 0:
            raise ValueError("If topk_mode is 'none' then k must be <= 0")
    else:
        raise ValueError(f"Unknown topk_mode [{topk_mode}]")

    dists = dists.reshape(B, HD, T, nH, nW, -1)
    inds = torch.movedim(inds3.reshape(3, B, HD, T, nH, nW, -1), 0, -1)
    return dists, inds


def _pallas_topk_aux(dists, aux, *, self_action, k, dist_type):
    """self_action + top-K selection over the search volume: the rule the
    search kernel reproduces. The anchor takes the lexicographically first
    argmin of |dt|+|dh|+|dw| from the separable offsets in `aux`
    (dt_tab[t,wt], dh[..,wt,wi,y,x], dw[..,wt,wj,y,x]); per-axis first
    argmins compose to the flat one. Cell 0 and the self cell swap places
    before ranking, and ties break by lower position, as in `lax.top_k`
    (a stable sort here: torch.topk is not stable).

    dists [B,HD,T,W_t,ws,ws,nH,nW] -> (dists [B,HD,T,nH,nW,K],
    cells [B,HD,T,nH,nW,K] flat ids (st*ws + wi)*ws + wj)."""
    B, HD, T, W_t, ws, _, nH, nW = dists.shape
    S = W_t * ws * ws
    d = dists.permute(0, 1, 2, 6, 7, 3, 4, 5).reshape(B, HD, T, nH, nW, S)
    _, descending, _ = dist_type_select(dist_type)
    kk = min(k, S)

    def ranked(key, n):
        return torch.sort(key, dim=-1, descending=descending,
                          stable=True)[1][..., :n]

    if self_action not in ("anchor", "anchor_self"):
        cells = ranked(d, kk)
        return torch.gather(d, -1, cells), cells
    # [B,HD,T,W_t,ws,nH,nW] -> [B,HD,T,nH,nW,W_t,ws]
    mh, ah = torch.min(aux["dh"].permute(0, 1, 2, 5, 6, 3, 4).float().abs(),
                       -1)                            # first argmins
    mw, aw = torch.min(aux["dw"].permute(0, 1, 2, 5, 6, 3, 4).float().abs(),
                       -1)
    tot = aux["dt_tab"].float().abs().reshape(1, 1, T, 1, 1, W_t) + mh + mw
    wts = torch.argmin(tot, -1, keepdim=True)         # [B,HD,T,nH,nW,1]
    self_idx = (wts * ws + torch.gather(ah, -1, wts)) * ws \
        + torch.gather(aw, -1, wts)
    s_ids = torch.arange(S, device=d.device)
    dself = torch.gather(d, -1, self_idx)
    d_anch = torch.where(s_ids == 0, dself,
                         torch.where(s_ids == self_idx, d[..., :1], d))
    pos = ranked(d_anch[..., 1:], kk - 1) + 1         # anchored slots
    # the anchored slot self_idx holds the ORIGINAL slot-0 entry
    s_sel = torch.where(pos == self_idx, 0, pos)
    return (torch.cat([dself, torch.gather(d_anch, -1, pos)], -1),
            torch.cat([self_idx, s_sel], -1))


def patch_fold_counts(H, W, ps, stride):
    """Pixel coverage counts of a ps x ps / stride patch fold (zero padding,
    centre-cropped): the normalize_bwd divisor."""
    nH = (H - 1) // stride + 1
    nW = (W - 1) // stride + 1
    pad = (ps - 1) // 2
    Hp, Wp = H + 2 * pad, W + 2 * pad
    counts = np.zeros((Hp, Wp), np.float32)
    for ih in range(nH):
        for iw in range(nW):
            counts[ih * stride:ih * stride + ps,
                   iw * stride:iw * stride + ps] += 1.
    sH, sW = (Hp - H + 1) // 2, (Wp - W + 1) // 2
    return counts[sH:sH + H, sW:sW + W]


def _lazy_topk_ok(cfg):
    return (cfg["self_action"] in (None, "anchor", "anchor_self")
            and cfg["topk_mode"] == "all" and cfg["k"] > 0)


def _not_ported(cfg):
    """Why the port cannot run `cfg` yet, or None."""
    if cfg["pt"] != 1 or not cfg["reflect_bounds"]:
        return "pt != 1 or reflect_bounds=False"
    if cfg["strideQ"] not in (None, cfg["stride0"]):
        return "strideQ != stride0"
    if cfg["off_Hq"] != 0 or cfg["off_Wq"] != 0 or cfg["ws_interior"] > 0:
        return "off_Hq/off_Wq/ws_interior"
    if not float(cfg["dilation"]).is_integer():
        return "fractional dilation"
    return None


def _sparse_k_pad_ok(cfg, vid_shape):
    """The patch reads reflect once: the taps' reach plus the bilinear
    corner (the pad of ops/nls_k.dists_at_positions) must fit the frame."""
    H, W = vid_shape[-2:]
    return int(cfg["dilation"]) * (cfg["ps"] - 1) + 2 <= min(H, W) - 1


def search_route(cfg, vid_shape, T_global=None):
    """The route nls_pipeline takes for `cfg` on videos of vid_shape
    [B,HD,T,F,H,W] (a chunk of a sequence of T_global frames when given),
    on every device: "topk" (B1 selects, B2 backward) or "volume" (B5/B6
    and the menu). A lazy top-K with more ranked slots than B1 keeps takes
    the volume: both give the exact top-K of the same volume."""
    T = vid_shape[2] if T_global is None else T_global
    n_cells = min(2 * cfg["wt"] + 1, T) * cfg["ws"] ** 2
    lazy = (_lazy_topk_ok(cfg)
            and cfg.get("grad", "auto") in ("auto", "sparse_k")
            and _sparse_k_pad_ok(cfg, vid_shape)
            and ranked_slots(cfg["k"], cfg["self_action"] is not None,
                             n_cells) <= KMAX)
    return "topk" if lazy else "volume"


def _select_cells(vid0, vid1, flows, cfg, chunk):
    """Selected dists and flat window-cell ids [B,HD,T,nH,nW,K] (f32,
    int32), from the search kernel. Callers pass detached inputs under
    no_grad: selection is not differentiable."""
    return nls_topk(
        vid0.contiguous(), vid1.contiguous(), flows.contiguous(),
        ws=cfg["ws"], wt=cfg["wt"], ps=cfg["ps"], stride0=cfg["stride0"],
        stride1=cfg["stride1"], k=cfg["k"],
        anchor=cfg["self_action"] is not None, dist_type=cfg["dist_type"],
        dilation=int(cfg["dilation"]), full_ws=cfg["full_ws"],
        use_adj=cfg["use_adj"], itype=cfg["itype"], **chunk)


def _sparse_assemble(vid0, vid1, flows, d_sel, cells, cfg, chunk):
    """The selected dists with their gradient (B2) and the cells'
    offsets, both differentiable in the flows through the geometry."""
    H, W = vid0.shape[-2:]
    geo = cells_geometry(flows, cells, H=H, W=W, ws=cfg["ws"], wt=cfg["wt"],
                         stride0=cfg["stride0"], stride1=cfg["stride1"],
                         full_ws=cfg["full_ws"], itype=cfg["itype"],
                         halo=(vid0.shape[2] - cells.shape[2]) // 2, **chunk)
    d = search_dists(vid0, vid1, geo["prop_h"], geo["prop_w"], d_sel,
                     geo["tj_k"], geo["valid"], ps=cfg["ps"],
                     stride0=cfg["stride0"], dist_type=cfg["dist_type"],
                     dilation=int(cfg["dilation"]), use_adj=cfg["use_adj"],
                     itype=cfg["itype"], **chunk)
    inds = torch.stack([geo["dt"], geo["dh"], geo["dw"]], dim=-1)
    if cfg["self_action"] in ("anchor", "anchor_self"):
        # anchored slot-0 offsets are exact zeros; its dist is the self
        # cell's, with its gradient through the positions
        inds = torch.cat([torch.zeros_like(inds[..., :1, :]),
                          inds[..., 1:, :]], dim=-2)
    return d, inds


def _volume_search(vid0, vid1, flows, cfg, chunk):
    """The full volume (B5, backward B6) at the flows' centres, the
    offsets of every cell, then the self_action and top-K menu."""
    kw = dict(ws=cfg["ws"], wt=cfg["wt"], stride0=cfg["stride0"],
              stride1=cfg["stride1"], full_ws=cfg["full_ws"],
              itype=cfg["itype"], **chunk)
    aux = search_aux(vid0.shape, flows, **kw)
    dists = search_volume(
        vid0, vid1, aux["ctr_h"], aux["ctr_w"], ps=cfg["ps"],
        dist_type=cfg["dist_type"], dilation=int(cfg["dilation"]),
        use_adj=cfg["use_adj"], **kw)
    return _self_action_topk(
        dists, aux_to_inds3(aux, dists.shape),
        self_action=cfg["self_action"], topk_mode=cfg["topk_mode"],
        k=cfg["k"], wt=cfg["wt"], dist_type=cfg["dist_type"])


def nls_pipeline(vid0, vid1, flows, cfg, query_t0=None, T_global=None):
    """Forward: the lazy top-K route (select the K cells and their dists,
    then attach the geometry and the backward) where `search_route` takes
    it, else the full volume. vid0/vid1 [B,HD,T,F,H,W]; flows
    [B,HDf,T,W_t(-1),2,nH,nW] -> (dists [B,HD,T,nH,nW,K],
    inds [B,HD,T,nH,nW,K,3]). With query_t0 and T_global, one temporal
    chunk: the videos hold the flows' T query frames plus a halo on each
    side, and the outputs cover the query frames."""
    why = _not_ported(cfg)
    if why is not None:
        raise NotImplementedError(
            f"NonLocalSearch with {why} is not yet ported, see ROADMAP")
    chunk = dict(query_t0=query_t0, T_global=T_global)
    if search_route(cfg, vid0.shape, T_global) == "volume":
        return _volume_search(vid0, vid1, flows, cfg, chunk)
    with torch.no_grad():
        d_sel, cells = _select_cells(vid0.detach(), vid1.detach(),
                                     flows.detach(), cfg, chunk)
    return _sparse_assemble(vid0, vid1, flows, d_sel, cells, cfg, chunk)


class _ScaleGrad(torch.autograd.Function):
    """Identity forward; divides the incoming gradient by `counts`."""

    @staticmethod
    def forward(ctx, x, counts):
        ctx.save_for_backward(counts)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        counts, = ctx.saved_tensors
        return g / counts, None


class _KeepGrad(torch.autograd.Function):
    """Identity forward; zeroes the gradient of neighbours k >= k_agg."""

    @staticmethod
    def forward(ctx, x, k_agg, k_axis):
        ctx.k_agg, ctx.k_axis = k_agg, k_axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        keep = torch.arange(g.shape[ctx.k_axis], device=g.device) < ctx.k_agg
        shape = [1] * g.ndim
        shape[ctx.k_axis] = -1
        return g * keep.reshape(shape).to(g.dtype), None, None


def _make_grad_policy_fn(cfg):
    """nls_pipeline with k_agg truncation / normalize_bwd when asked: the
    cotangents of neighbours past k_agg are dropped, and the video
    gradients are divided by the patch fold counts."""
    k_agg = cfg["k_agg"]
    normalize_bwd = cfg["normalize_bwd"]

    def fn(vid0, vid1, flows):
        if normalize_bwd:
            H, W = vid0.shape[-2:]
            c0 = torch.as_tensor(patch_fold_counts(H, W, cfg["ps"],
                                                   cfg["stride0"]),
                                 device=vid0.device)
            c1 = torch.as_tensor(patch_fold_counts(H, W, cfg["ps"],
                                                   int(cfg["stride1"])),
                                 device=vid1.device)
            vid0 = _ScaleGrad.apply(vid0, c0)
            vid1 = _ScaleGrad.apply(vid1, c1)
        dists, inds = nls_pipeline(vid0, vid1, flows, cfg)
        if k_agg is not None and k_agg > 0:
            dists = _KeepGrad.apply(dists, k_agg, -1)
            inds = _KeepGrad.apply(inds, k_agg, -2)
        return dists, inds

    return fn


class NonLocalSearch(torch.nn.Module):
    """Space-time non-local search module.

    Call patterns:
      search(vid0, vid1)                  -> zero flows
      search(vid0, vid1, flows)           -> precomputed [B,(HD),T,W_t(-1),2,nH,nW]
      search(vid0, vid1, fflow, bflow)    -> flows from nn.search_flow
    """

    def __init__(self, ws, wt, ps=1, k=-1, nheads=1, stride0=1, stride1=1,
                 dist_type="l2", dilation=1, pt=1, self_action=None,
                 topk_mode="all", ws_interior=0, reflect_bounds=True,
                 full_ws=True, use_adj=False, normalize_bwd=False, k_agg=-1,
                 off_Hq=0, off_Wq=0, strideQ=None, itype="float",
                 impl="auto", flow_budget="auto", cv_tile=None,
                 spread_budget="auto", qchunk=None, band_dtype=None,
                 grad="auto", channel_chunk=4, mx_precision="high"):
        super().__init__()
        self.cfg = dict(
            ws=ws, wt=wt, ps=ps, k=k, nheads=nheads, stride0=stride0,
            stride1=stride1, dist_type=dist_type, dilation=dilation, pt=pt,
            self_action=self_action, topk_mode=topk_mode,
            ws_interior=ws_interior, reflect_bounds=reflect_bounds,
            full_ws=full_ws, use_adj=use_adj, normalize_bwd=normalize_bwd,
            k_agg=k_agg, off_Hq=off_Hq, off_Wq=off_Wq, strideQ=strideQ,
            itype=itype, impl=impl, flow_budget=flow_budget,
            cv_tile=cv_tile, spread_budget=spread_budget, qchunk=qchunk,
            band_dtype=band_dtype, grad=grad, channel_chunk=channel_chunk,
            mx_precision=mx_precision)
        for key, val in self.cfg.items():
            setattr(self, key, val)
        why = _not_ported(self.cfg)
        if why is not None:
            raise NotImplementedError(
                f"NonLocalSearch with {why} is not yet ported, see ROADMAP")
        self._fn = _make_grad_policy_fn(self.cfg)

    def forward(self, *args):
        if self.ws <= 0 or self.wt < 0:
            raise ValueError("need ws > 0 and wt >= 0")
        vid0, vid1 = args[:2]
        if len(args) == 4:
            from stnls_tpu_torch.nn.flow import search_flow
            flows = search_flow(args[2], args[3], self.wt, self.stride0)
        elif len(args) == 3:
            flows = args[2]
        else:
            vid0s = shape_vids(self.nheads, [vid0])[0]
            flows = empty_flows(vid0s, self.wt, self.stride0)
        vid0, vid1 = shape_vids(self.nheads, [vid0, vid1])
        flows = shape_flows(self.nheads, flows)
        return self._fn(vid0, vid1, flows)

    def flops(self, T, F, H, W):
        """Useful-work flop model of the JAX package's NonLocalSearch: the
        patch distances (a bilinear read and l2 per tap and channel: 7
        flops float, 2 int) of every window cell, plus ~S log2(K) compares
        a query for the top-K."""
        nrefs = T * ((H - 1) // self.stride0 + 1) \
            * ((W - 1) // self.stride0 + 1)
        nsearch = self.ws * self.ws * (2 * self.wt + 1)
        per_tap = 7 if self.itype == "float" else 2
        flops_per = per_tap * F * self.ps * self.ps * self.pt
        total = nrefs * nsearch * flops_per * self.nheads
        if self.k > 0:
            total += int(nrefs * self.nheads * nsearch
                         * np.log2(max(min(self.k, nsearch), 2)))
        return total

    def radius(self, *args):
        return self.ws


def _apply(vid0, vid1, flows, ws, wt, ps=1, k=-1, nheads=1, stride0=1,
           stride1=1, dist_type="l2", dilation=1, pt=1, self_action=None,
           topk_mode="all", ws_interior=0, reflect_bounds=True, full_ws=True,
           use_adj=False, normalize_bwd=False, k_agg=-1, off_Hq=0, off_Wq=0,
           strideQ=None, itype="float"):
    """Functional API: stnls_tpu_torch.search.nls(...)."""
    search = NonLocalSearch(
        ws, wt, ps, k, nheads=nheads, stride0=stride0, stride1=stride1,
        dist_type=dist_type, dilation=dilation, pt=pt,
        self_action=self_action, topk_mode=topk_mode,
        ws_interior=ws_interior, reflect_bounds=reflect_bounds,
        full_ws=full_ws, use_adj=use_adj, normalize_bwd=normalize_bwd,
        k_agg=k_agg, off_Hq=off_Hq, off_Wq=off_Wq, strideQ=strideQ,
        itype=itype)
    return search(vid0, vid1, flows)


def extract_config(cfg, restrict=True):
    pairs = {"ws": -1, "wt": -1, "ps": 1, "k": -1,
             "nheads": 1, "dist_type": "l2",
             "stride0": 1, "stride1": 1, "dilation": 1, "pt": 1,
             "ws_interior": 0, "reflect_bounds": True, "full_ws": True,
             "self_action": None, "use_adj": False,
             "normalize_bwd": False, "k_agg": -1, "topk_mode": "all",
             "off_Hq": 0, "off_Wq": 0, "strideQ": None, "itype": "float",
             "impl": "auto", "flow_budget": "auto", "spread_budget": "auto",
             "cv_tile": None, "qchunk": None, "band_dtype": None,
             "grad": "auto", "channel_chunk": 4, "mx_precision": "high"}
    return extract_pairs(cfg, pairs, restrict=restrict)


def init(cfg):
    cfg = extract_config(cfg, False)
    return NonLocalSearch(
        cfg.ws, cfg.wt, cfg.ps, cfg.k, nheads=cfg.nheads,
        stride0=cfg.stride0, stride1=cfg.stride1, dist_type=cfg.dist_type,
        dilation=cfg.dilation, pt=cfg.pt, self_action=cfg.self_action,
        topk_mode=cfg.topk_mode, ws_interior=cfg.ws_interior,
        reflect_bounds=cfg.reflect_bounds, full_ws=cfg.full_ws,
        use_adj=cfg.use_adj, normalize_bwd=cfg.normalize_bwd,
        k_agg=cfg.k_agg, off_Hq=cfg.off_Hq, off_Wq=cfg.off_Wq,
        strideQ=cfg.strideQ, itype=cfg.itype,
        impl=cfg.impl, flow_budget=cfg.flow_budget, cv_tile=cfg.cv_tile,
        spread_budget=cfg.spread_budget, qchunk=cfg.qchunk,
        band_dtype=cfg.band_dtype, grad=cfg.grad,
        channel_chunk=cfg.channel_chunk, mx_precision=cfg.mx_precision)
