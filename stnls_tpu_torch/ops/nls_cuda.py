"""B1 and B2: the search forward with in-kernel top-K and its K-sparse
backward (CUDA, Hopper).

B1 mirrors stnls_tpu/ops/nls_pallas.py::nls_pallas_topk. `nls_topk`
launches csrc/nls_topk_fwd.cu on CUDA tensors and returns the K winning
distances and their flat window-cell ids (st*ws + wi)*ws + wj. The search
calls it under no_grad: it selects the cells and its distances are the
search's forward values. It takes no flow or spread budgets: it is exact
for any flow.

B2 mirrors stnls_tpu/ops/nls_pallas_bwd.py::topk_bwd_pallas.
`search_dists` is the torch.autograd.Function around the two, as the
custom_vjp `_topk_op` is in the JAX package: its forward returns B1's
distances, its inputs are the videos and the sampled key positions
(ops/nls_k.cells_geometry, differentiable in the flows), and its backward
is `nls_topk_bwd`, which launches csrc/nls_topk_bwd.cu and returns the
gradients to both videos and to the positions.

`nls_topk_plain` (the exhaustive volume of ops/nls.nls_search_volume, the
separable offsets of ops/nls_k.search_aux and the selection rule of
search.non_local_search._pallas_topk_aux) and `nls_topk_bwd_plain` (the
VJP of ops/nls_k.dists_at_positions) are the kernels' plain PyTorch
versions. The wrappers take them only for tensors on the CPU; for a CUDA
tensor they launch the kernel or raise.

All of them take the temporal-chunk mode of time sharding, as
nls_pallas_topk does: with query_t0 and T_global the videos hold the
T_local query frames plus `halo` frames on each side (halo = (T_v -
T_local) / 2 >= 2*wt), the flows and outputs the T_local query frames,
and the windows are the whole sequence's (ops/nls.chunk_frames).
"""

import torch

from stnls_tpu_torch.ops import cuda_lib
from stnls_tpu_torch.ops.geometry import num_queries
from stnls_tpu_torch.ops.nls import nls_search_volume, chunk_frames
from stnls_tpu_torch.ops.nls_k import search_aux, dists_at_positions

# B1 takes its body with ps and F compiled in (the query patch in
# registers, csrc/nls_common.cuh) for the pairs csrc/nls_topk_fwd.cu lists,
# where the card ran it faster (PERF.md); False forces the run-time body.
COMPILED_BODY = True
# The ranked slots B1 keeps per query (csrc/nls_topk_fwd.cu); the search
# sends a config with more to the volume route
KMAX = 64


def ranked_slots(k, anchor, n_cells):
    """The slots B1 ranks for a top-k over n_cells window cells: K =
    min(k, n_cells), less the anchored self slot."""
    K = min(k, n_cells)
    return K - 1 if anchor else K


def nls_topk_plain(vid0, vid1, flows, *, ws, wt, ps, stride0, stride1, k,
                   anchor, dist_type="l2", dilation=1, full_ws=True,
                   use_adj=False, itype="float", query_t0=None,
                   T_global=None):
    """Plain version of B1. Same arguments and outputs as `nls_topk`."""
    from stnls_tpu_torch.search.non_local_search import _pallas_topk_aux
    chunk = dict(query_t0=query_t0, T_global=T_global)
    dists = nls_search_volume(
        vid0, vid1, flows, ws=ws, wt=wt, ps=ps, stride0=stride0,
        stride1=stride1, dist_type=dist_type, dilation=dilation,
        full_ws=full_ws, use_adj=use_adj, itype=itype, **chunk)
    aux = search_aux(vid0.shape, flows, ws=ws, wt=wt, stride0=stride0,
                     stride1=stride1, itype=itype, full_ws=full_ws,
                     **chunk) if anchor else None
    d, cells = _pallas_topk_aux(
        dists, aux, self_action="anchor" if anchor else None, k=k,
        dist_type=dist_type)
    return d, cells.int()


def _check(vid0, vid1, flows, *, ws, wt, ps, stride0, stride1, k, anchor,
           dist_type, dilation, itype, query_t0, T_global):
    """Raise on what B1 does not take; returns (t0, T_global, halo)."""
    for name, x in (("vid0", vid0), ("vid1", vid1), ("flows", flows)):
        if x.device.type != "cuda" or x.device != vid0.device:
            raise ValueError(f"nls_topk: {name} must be on vid0's CUDA device")
        if x.dtype != torch.float32:
            raise TypeError(f"nls_topk: {name} must be float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"nls_topk: {name} must be contiguous")
    if vid0.ndim != 6 or vid1.shape != vid0.shape:
        raise ValueError("nls_topk: vid0/vid1 must be equal [B,HD,T,F,H,W]")
    B, HD, T_v, F, H, W = vid0.shape
    if flows.ndim != 7:
        raise ValueError("nls_topk: flows must be [B,HDf,T,W_t(-1),2,nH,nW]")
    T = flows.shape[2]
    chunk = chunk_frames(T, T_v, wt, query_t0, T_global)
    W_t = min(2 * wt + 1, chunk[1])
    nH, nW = num_queries(H, W, stride0)
    if (flows.shape[0] != B or flows.shape[3] not in (W_t, W_t - 1)
            or flows.shape[4] != 2 or tuple(flows.shape[5:]) != (nH, nW)):
        raise ValueError(f"nls_topk: flows must be [B,HDf,T,W_t(-1),2,nH,nW],"
                         f" got {tuple(flows.shape)}")
    if ps < 1 or F < 1:
        raise ValueError(f"nls_topk: need ps >= 1 and F >= 1, got {ps}, {F}")
    if dist_type not in ("l2", "prod") or itype not in ("float", "int"):
        raise ValueError(f"nls_topk: dist_type={dist_type!r}, itype={itype!r}")
    if ws < 1 or wt < 0 or stride0 < 1 or not stride1 > 0:
        raise ValueError("nls_topk: need ws >= 1, wt >= 0, stride0 >= 1, "
                         "stride1 > 0")
    if int(dilation) != dilation or dilation < 1:
        raise NotImplementedError("nls_topk: integer dilation >= 1 only")
    if k < 1 or ranked_slots(k, anchor, W_t * ws * ws) > KMAX:
        raise NotImplementedError(
            f"nls_topk: k >= 1 and at most {KMAX} ranked slots (the search "
            "takes the volume route for more)")
    return chunk


def nls_topk(vid0, vid1, flows, *, ws, wt, ps, stride0, stride1, k, anchor,
             dist_type="l2", dilation=1, full_ws=True, use_adj=False,
             itype="float", query_t0=None, T_global=None):
    """Search top-K. vid0, vid1 [B,HD,T,F,H,W]; flows [B,HDf,T,W_t(-1),2,
    nH,nW] (channel 0 = w, 1 = h). Returns (dists [B,HD,T,nH,nW,K],
    cells int32 [B,HD,T,nH,nW,K]) with K = min(k, W_t*ws*ws); with
    `anchor` slot 0 holds the self cell. Chunk mode: see the module's
    docstring."""
    if vid0.device.type == "cpu":
        return nls_topk_plain(
            vid0, vid1, flows, ws=ws, wt=wt, ps=ps, stride0=stride0,
            stride1=stride1, k=k, anchor=anchor, dist_type=dist_type,
            dilation=dilation, full_ws=full_ws, use_adj=use_adj, itype=itype,
            query_t0=query_t0, T_global=T_global)
    t0, T_g, halo = _check(
        vid0, vid1, flows, ws=ws, wt=wt, ps=ps, stride0=stride0,
        stride1=stride1, k=k, anchor=anchor, dist_type=dist_type,
        dilation=dilation, itype=itype, query_t0=query_t0, T_global=T_global)
    B, HD, T_v, F, H, W = vid0.shape
    T = flows.shape[2]
    W_t = min(2 * wt + 1, T_g)
    K = min(k, W_t * ws * ws)
    nH, nW = num_queries(H, W, stride0)
    if itype == "int":
        stride1 = float(max(1, int(stride1)))
    else:
        stride1 = float(stride1)
    dists = torch.empty((B, HD, T, nH, nW, K), dtype=torch.float32,
                        device=vid0.device)
    cells = torch.empty((B, HD, T, nH, nW, K), dtype=torch.int32,
                        device=vid0.device)
    lib = cuda_lib.load()
    with torch.cuda.device(vid0.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.stnls_nls_topk_fwd(
            vid0.data_ptr(), vid1.data_ptr(), flows.data_ptr(),
            dists.data_ptr(), cells.data_ptr(),
            B, HD, T, F, H, W, flows.shape[1], flows.shape[3], nH, nW,
            T_v, t0, T_g, halo, ws, wt, ps, stride0, int(dilation), stride1,
            stride1 * ((ws - 1) // 2), K, int(bool(anchor)),
            int(dist_type == "l2"), int(bool(full_ws)), int(bool(use_adj)),
            int(itype == "int"), int(COMPILED_BODY), stream)
    cuda_lib.check_launch(err, "nls_topk")
    nls_topk.launches += 1
    return dists, cells


nls_topk.launches = 0


def nls_topk_bwd_plain(vid0, vid1, prop_h, prop_w, tj_k, valid, g_d, cfg,
                       query_t0=None, T_global=None):
    """Plain version of B2: the VJP of ops/nls_k.dists_at_positions,
    recomputed under enable_grad. Same arguments and outputs as
    `nls_topk_bwd`."""
    nls_topk_bwd_plain.calls += 1
    chunk_frames(prop_h.shape[2], vid0.shape[2], 0, query_t0, T_global)
    is_float = cfg["itype"] != "int"
    with torch.enable_grad():
        inputs = [vid0.detach().requires_grad_(),
                  vid1.detach().requires_grad_(),
                  prop_h.detach().requires_grad_(is_float),
                  prop_w.detach().requires_grad_(is_float)]
        d = dists_at_positions(*inputs, tj_k, valid, **cfg)
        wanted = [x for x in inputs if x.requires_grad]
        grads = iter(torch.autograd.grad(d, wanted, g_d))
    return tuple(next(grads) if x.requires_grad else torch.zeros_like(x)
                 for x in inputs)


nls_topk_bwd_plain.calls = 0


def nls_topk_bwd(vid0, vid1, prop_h, prop_w, tj_k, valid, g_d, cfg,
                 query_t0=None, T_global=None):
    """B2. vid0, vid1 [B,HD,T,F,H,W]; prop_h, prop_w, tj_k, valid and the
    cotangent g_d [B,HD,T,nH,nW,K]; cfg holds dists_at_positions' keywords
    (ps, stride0, dist_type, dilation, use_adj, itype). Returns (g_vid0,
    g_vid1, g_prop_h, g_prop_w); the position gradients are 0 in the int
    path and for invalid cells. In chunk mode (query_t0, T_global) the
    videos hold the T query frames plus a halo on each side, and tj_k
    indexes them."""
    if vid0.device.type == "cpu":
        return nls_topk_bwd_plain(vid0, vid1, prop_h, prop_w, tj_k, valid,
                                  g_d, cfg, query_t0, T_global)
    B, HD, T_v, F, H, W = vid0.shape
    T = g_d.shape[2]
    _, _, halo = chunk_frames(T, T_v, 0, query_t0, T_global)
    nH, nW, K = g_d.shape[-3:]
    for name, x in (("vid0", vid0), ("vid1", vid1), ("prop_h", prop_h),
                    ("prop_w", prop_w), ("g_d", g_d)):
        if x.device != vid0.device or x.dtype != torch.float32:
            raise TypeError(f"nls_topk_bwd: {name} must be float32 on "
                            "vid0's CUDA device")
    if vid1.shape != vid0.shape or (nH, nW) != num_queries(
            H, W, cfg["stride0"]) or not (
            prop_h.shape == prop_w.shape == tj_k.shape == valid.shape
            == g_d.shape == (B, HD, T, nH, nW, K)):
        raise ValueError("nls_topk_bwd: vid0/vid1 [B,HD,T,F,H,W] and "
                         "positions, frames, validity and g_d "
                         "[B,HD,T,nH,nW,K] expected")
    if int(cfg["dilation"]) != cfg["dilation"] or cfg["dilation"] < 1:
        raise NotImplementedError("nls_topk_bwd: integer dilation >= 1 only")
    if cfg["dist_type"] not in ("l2", "prod") or \
            cfg["itype"] not in ("float", "int"):
        raise ValueError(f"nls_topk_bwd: dist_type={cfg['dist_type']!r}, "
                         f"itype={cfg['itype']!r}")
    vid0, vid1 = vid0.contiguous(), vid1.contiguous()
    prop_h, prop_w = prop_h.contiguous(), prop_w.contiguous()
    g_d = g_d.contiguous()
    tj = torch.where(valid, tj_k, -1).to(torch.int32).contiguous()
    g_vid0 = torch.zeros_like(vid0)
    g_vid1 = torch.zeros_like(vid1)
    g_prop_h = torch.empty_like(prop_h)
    g_prop_w = torch.empty_like(prop_w)
    lib = cuda_lib.load()
    with torch.cuda.device(vid0.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.stnls_nls_topk_bwd(
            vid0.data_ptr(), vid1.data_ptr(), prop_h.data_ptr(),
            prop_w.data_ptr(), tj.data_ptr(), g_d.data_ptr(),
            g_vid0.data_ptr(), g_vid1.data_ptr(), g_prop_h.data_ptr(),
            g_prop_w.data_ptr(), B, HD, T, F, H, W, nH, nW, K, T_v, halo,
            cfg["ps"],
            cfg["stride0"], int(cfg["dilation"]), int(bool(cfg["use_adj"])),
            int(cfg["dist_type"] == "l2"), int(cfg["itype"] == "int"),
            stream)
    cuda_lib.check_launch(err, "nls_topk_bwd")
    nls_topk_bwd.launches += 1
    return g_vid0, g_vid1, g_prop_h, g_prop_w


nls_topk_bwd.launches = 0


class _SearchDists(torch.autograd.Function):
    """Forward: the distances the selecting kernel computed (B1, or its
    plain version on the CPU), as they are. Backward: B2."""

    @staticmethod
    def forward(ctx, vid0, vid1, prop_h, prop_w, dists, tj_k, valid, cfg,
                chunk):
        ctx.save_for_backward(vid0, vid1, prop_h, prop_w, tj_k, valid)
        ctx.cfg, ctx.chunk = cfg, chunk
        return dists.view_as(dists)

    @staticmethod
    def backward(ctx, g_d):
        vid0, vid1, prop_h, prop_w, tj_k, valid = ctx.saved_tensors
        grads = nls_topk_bwd(vid0, vid1, prop_h, prop_w, tj_k, valid, g_d,
                             ctx.cfg, *ctx.chunk)
        return grads + (None,) * 5


def search_dists(vid0, vid1, prop_h, prop_w, dists, tj_k, valid, *, ps,
                 stride0=1, dist_type="l2", dilation=1, use_adj=False,
                 itype="float", query_t0=None, T_global=None):
    """The search's K distances with their gradient. dists
    [B,HD,T,nH,nW,K] are the selecting kernel's values at the cells whose
    key positions prop_h, prop_w, target frames tj_k and validity are
    given (ops/nls_k.cells_geometry); returns them, differentiable in
    vid0, vid1 and the positions through B2 (in chunk mode with
    query_t0, T_global)."""
    cfg = dict(ps=ps, stride0=stride0, dist_type=dist_type,
               dilation=dilation, use_adj=use_adj, itype=itype)
    return _SearchDists.apply(vid0, vid1, prop_h, prop_w, dists, tj_k,
                              valid, cfg, (query_t0, T_global))
