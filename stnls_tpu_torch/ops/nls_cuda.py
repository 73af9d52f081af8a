"""B1: the fused search forward with in-kernel top-K (CUDA, Hopper).

Mirrors stnls_tpu/ops/nls_pallas.py::nls_pallas_topk. `nls_topk` launches
csrc/nls_topk_fwd.cu on CUDA tensors and returns the K winning distances
and their flat window-cell ids (st*ws + wi)*ws + wj. It is a selection
kernel: the search calls it under no_grad, and the winners' values and
gradients come from the plain recompute ops/nls_k.nls_dists_at_cells, so
it needs no autograd.Function. It takes no flow or spread budgets: it is
exact for any flow.

`nls_topk_plain` is its plain PyTorch version: the exhaustive volume
(ops/nls.nls_search_volume), its separable offsets (ops/nls_k.search_aux)
and the selection rule of search.non_local_search._pallas_topk_aux. The
wrapper takes it only for tensors on the CPU; for a CUDA tensor it
launches the kernel or raises.
"""

import torch

from stnls_tpu_torch.ops import cuda_lib
from stnls_tpu_torch.ops.geometry import num_queries
from stnls_tpu_torch.ops.nls import nls_search_volume
from stnls_tpu_torch.ops.nls_k import search_aux

# (ps, F a head) pairs the kernel is instantiated for (csrc/nls_topk_fwd.cu):
# those the repo's entry points launch
KERNEL_CONFIGS = ((3, 8), (3, 16))
KMAX = 64


def nls_topk_plain(vid0, vid1, flows, *, ws, wt, ps, stride0, stride1, k,
                   anchor, dist_type="l2", dilation=1, full_ws=True,
                   use_adj=False, itype="float"):
    """Plain version of B1. Same arguments and outputs as `nls_topk`."""
    from stnls_tpu_torch.search.non_local_search import _pallas_topk_aux
    dists = nls_search_volume(
        vid0, vid1, flows, ws=ws, wt=wt, ps=ps, stride0=stride0,
        stride1=stride1, dist_type=dist_type, dilation=dilation,
        full_ws=full_ws, use_adj=use_adj, itype=itype)
    aux = search_aux(vid0.shape, flows, ws=ws, wt=wt, stride0=stride0,
                     stride1=stride1, itype=itype, full_ws=full_ws) \
        if anchor else None
    d, cells = _pallas_topk_aux(
        dists, aux, self_action="anchor" if anchor else None, k=k,
        dist_type=dist_type)
    return d, cells.int()


def _check(vid0, vid1, flows, *, ws, wt, ps, stride0, stride1, k, anchor,
           dist_type, dilation, itype):
    for name, x in (("vid0", vid0), ("vid1", vid1), ("flows", flows)):
        if x.device.type != "cuda" or x.device != vid0.device:
            raise ValueError(f"nls_topk: {name} must be on vid0's CUDA device")
        if x.dtype != torch.float32:
            raise TypeError(f"nls_topk: {name} must be float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"nls_topk: {name} must be contiguous")
    if vid0.ndim != 6 or vid1.shape != vid0.shape:
        raise ValueError("nls_topk: vid0/vid1 must be equal [B,HD,T,F,H,W]")
    B, HD, T, F, H, W = vid0.shape
    W_t = min(2 * wt + 1, T)
    nH, nW = num_queries(H, W, stride0)
    if (flows.ndim != 7 or flows.shape[0] != B or flows.shape[2] != T
            or flows.shape[3] not in (W_t, W_t - 1) or flows.shape[4] != 2
            or tuple(flows.shape[5:]) != (nH, nW)):
        raise ValueError(f"nls_topk: flows must be [B,HDf,T,W_t(-1),2,nH,nW],"
                         f" got {tuple(flows.shape)}")
    if (ps, F) not in KERNEL_CONFIGS:
        raise NotImplementedError(
            f"nls_topk: kernel built for (ps, F a head) in {KERNEL_CONFIGS}, "
            f"got ps={ps}, F={F}; not yet ported, see ROADMAP")
    if dist_type not in ("l2", "prod") or itype not in ("float", "int"):
        raise ValueError(f"nls_topk: dist_type={dist_type!r}, itype={itype!r}")
    if ws < 1 or wt < 0 or stride0 < 1 or not stride1 > 0:
        raise ValueError("nls_topk: need ws >= 1, wt >= 0, stride0 >= 1, "
                         "stride1 > 0")
    if int(dilation) != dilation or dilation < 1:
        raise NotImplementedError("nls_topk: integer dilation >= 1 only")
    if k < 1 or (k - 1 if anchor else k) > KMAX:
        raise NotImplementedError(f"nls_topk: 1 <= ranked slots <= {KMAX}")


def nls_topk(vid0, vid1, flows, *, ws, wt, ps, stride0, stride1, k, anchor,
             dist_type="l2", dilation=1, full_ws=True, use_adj=False,
             itype="float"):
    """Search top-K. vid0, vid1 [B,HD,T,F,H,W]; flows [B,HDf,T,W_t(-1),2,
    nH,nW] (channel 0 = w, 1 = h). Returns (dists [B,HD,T,nH,nW,K],
    cells int32 [B,HD,T,nH,nW,K]) with K = min(k, W_t*ws*ws); with
    `anchor` slot 0 holds the self cell."""
    if vid0.device.type == "cpu":
        return nls_topk_plain(
            vid0, vid1, flows, ws=ws, wt=wt, ps=ps, stride0=stride0,
            stride1=stride1, k=k, anchor=anchor, dist_type=dist_type,
            dilation=dilation, full_ws=full_ws, use_adj=use_adj, itype=itype)
    _check(vid0, vid1, flows, ws=ws, wt=wt, ps=ps, stride0=stride0,
           stride1=stride1, k=k, anchor=anchor, dist_type=dist_type,
           dilation=dilation, itype=itype)
    B, HD, T, F, H, W = vid0.shape
    W_t = min(2 * wt + 1, T)
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
            ws, wt, ps, stride0, int(dilation), stride1,
            stride1 * ((ws - 1) // 2), K, int(bool(anchor)),
            int(dist_type == "l2"), int(bool(full_ws)), int(bool(use_adj)),
            int(itype == "int"), stream)
    cuda_lib.check_launch(err, "nls_topk")
    nls_topk.launches += 1
    return dists, cells


nls_topk.launches = 0
