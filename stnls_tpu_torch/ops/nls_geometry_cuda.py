"""G1 and G2: the lazy top-K route's cell geometry in one launch, and its
flow backward (CUDA, Hopper).

`nls_geometry` turns the K window cells that the search kernel selected
(ops/nls_cuda.nls_topk, flat ids (st*ws + wi)*ws + wj) and the flows into
what the lazy route (search/non_local_search._sparse_assemble) hands on:
the sampled key positions prop_h, prop_w (differentiable in the flows in
the float path), the target frames tj_k, the validity mask and the offsets
inds [..,K,3] (dt, dh, dw), slot 0 zero under an anchored self_action. On
CUDA tensors it launches csrc/nls_geometry.cu: G1 writes every output
once, and G2, its backward, gives the flows their gradient where they
require one. On CPU tensors it takes the plain version
`nls_geometry_plain`: ops/nls_k.cells_geometry, the stack of its offsets
and the anchored slot; `nls_geometry_bwd_plain`, autograd through it, is
G2's plain version.

Both take the temporal-chunk mode of time sharding (query_t0, T_global,
halo: ops/nls.chunk_frames), where tj_k indexes videos that hold `halo`
frames before the chunk's first query frame.

The kernel's tj_k is int32, the plain version's int64; B2's wrapper and
the plain B2 take either. The positions are those of B1's lattice
(csrc/nls_common.cuh), bitwise. On the card torch divides a tensor by a
scalar through the scalar's reciprocal, so cells_geometry run there on
CUDA tensors agrees with them bitwise where stride1 is a power of two
(1/stride1 exact), as every configuration of the port's is.
"""

import torch

from stnls_tpu_torch.ops import cuda_lib
from stnls_tpu_torch.ops.geometry import num_queries
from stnls_tpu_torch.ops.nls_k import cells_geometry


def nls_geometry_plain(flows, cells, *, H, W, ws, wt, stride0, stride1,
                       full_ws=True, itype="float", anchor=False,
                       query_t0=None, T_global=None, halo=0):
    """Plain version of G1 (its autograd that of G2). Same arguments and
    outputs as `nls_geometry`."""
    geo = cells_geometry(flows, cells, H=H, W=W, ws=ws, wt=wt,
                         stride0=stride0, stride1=stride1, full_ws=full_ws,
                         itype=itype, query_t0=query_t0, T_global=T_global,
                         halo=halo)
    inds = torch.stack([geo["dt"], geo["dh"], geo["dw"]], dim=-1)
    if anchor:
        # anchored slot-0 offsets are exact zeros; its dist is the self
        # cell's, with its gradient through the positions
        inds = torch.cat([torch.zeros_like(inds[..., :1, :]),
                          inds[..., 1:, :]], dim=-2)
    return geo["prop_h"], geo["prop_w"], geo["tj_k"], geo["valid"], inds


def _check(flows, cells, *, H, W, ws, wt, stride0, T_global):
    """Raise on what G1 and G2 do not take; returns (nH, nW)."""
    if flows.device.type != "cuda" or cells.device != flows.device:
        raise ValueError("nls_geometry: flows and cells must be on one CUDA "
                         "device")
    if flows.dtype != torch.float32 or cells.dtype != torch.int32:
        raise TypeError(f"nls_geometry: float32 flows and int32 cells, got "
                        f"{flows.dtype} and {cells.dtype}")
    if cells.ndim != 6 or flows.ndim != 7:
        raise ValueError("nls_geometry: cells [B,HD,T,nH,nW,K] and flows "
                         "[B,HDf,T,W_t(-1),2,nH,nW] expected")
    B, HD, T, _, _, K = cells.shape
    nH, nW = num_queries(H, W, stride0)
    W_t = min(2 * wt + 1, T if T_global is None else T_global)
    if cells.shape[3:5] != (nH, nW):
        raise ValueError("cells must cover the full query grid")
    if (flows.shape[0] != B or flows.shape[2] != T
            or flows.shape[3] not in (W_t, W_t - 1) or flows.shape[4] != 2
            or tuple(flows.shape[5:]) != (nH, nW)):
        raise ValueError(f"nls_geometry: flows must be [B,HDf,T,W_t(-1),2,"
                         f"nH,nW], got {tuple(flows.shape)}")
    if ws < 1 or wt < 0 or stride0 < 1 or K < 1:
        raise ValueError("nls_geometry: need ws >= 1, wt >= 0, stride0 >= 1 "
                         "and K >= 1")
    return nH, nW


class _Geometry(torch.autograd.Function):
    """Forward: G1. Backward: G2, the flows' gradient (zero in the int
    path, whose flows are rounded)."""

    @staticmethod
    def forward(ctx, flows, cells, kw):
        out = _geometry_fwd(flows, cells, **kw)
        ctx.mark_non_differentiable(*out[2:4])
        if kw["itype"] == "int":
            ctx.mark_non_differentiable(out[4])
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(flows, cells)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, g_ph, g_pw, g_tj, g_valid, g_inds):
        flows, cells = ctx.saved_tensors
        if ctx.kw["itype"] == "int":
            return torch.zeros_like(flows), None, None
        return nls_geometry_bwd(flows, cells, g_ph, g_pw, g_inds,
                                **ctx.kw), None, None


def _geometry_fwd(flows, cells, *, H, W, ws, wt, stride0, stride1, full_ws,
                  itype, anchor, query_t0, T_global, halo):
    """G1's launch; see `nls_geometry`."""
    nH, nW = _check(flows, cells, H=H, W=W, ws=ws, wt=wt, stride0=stride0,
                    T_global=T_global)
    B, HD, T, _, _, K = cells.shape
    T_g = T if T_global is None else int(T_global)
    is_int = itype == "int"
    stride1 = float(max(1, int(stride1))) if is_int else float(stride1)
    dev = flows.device
    shape = tuple(cells.shape)
    prop_h = torch.empty(shape, dtype=torch.float32, device=dev)
    prop_w = torch.empty(shape, dtype=torch.float32, device=dev)
    tj = torch.empty(shape, dtype=torch.int32, device=dev)
    valid = torch.empty(shape, dtype=torch.bool, device=dev)
    inds = torch.empty(shape + (3,), device=dev,
                       dtype=torch.int32 if is_int else torch.float32)
    lib = cuda_lib.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.stnls_nls_geometry_fwd(
            cells.data_ptr(), flows.data_ptr(), prop_h.data_ptr(),
            prop_w.data_ptr(), tj.data_ptr(), valid.data_ptr(),
            inds.data_ptr(), B, HD, T, H, W, flows.shape[1], flows.shape[3],
            nH, nW, K, int(query_t0 or 0), T_g, int(halo), ws, wt, stride0,
            stride1, stride1 * ((ws - 1) // 2), int(bool(full_ws)),
            int(is_int), int(bool(anchor)), stream)
    cuda_lib.check_launch(err, "nls_geometry")
    nls_geometry.launches += 1
    return prop_h, prop_w, tj, valid, inds


def nls_geometry_bwd(flows, cells, g_ph, g_pw, g_inds, *, H, W, ws, wt,
                     stride0, stride1, full_ws, itype, anchor, query_t0,
                     T_global, halo):
    """G2: the float path's flow gradient [B,HDf,T,W_t(-1),2,nH,nW] from the
    cotangents of prop_h, prop_w and inds (each may be None: no
    cotangent)."""
    _check(flows, cells, H=H, W=W, ws=ws, wt=wt, stride0=stride0,
           T_global=T_global)
    B, HD, T, nH, nW, K = cells.shape
    g = [None if x is None else x.contiguous() for x in (g_ph, g_pw, g_inds)]
    g_flows = torch.empty_like(flows)
    lib = cuda_lib.load()
    with torch.cuda.device(flows.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.stnls_nls_geometry_bwd(
            cells.data_ptr(), flows.data_ptr(),
            *(None if x is None else x.data_ptr() for x in g),
            g_flows.data_ptr(), B, HD, T, H, W, flows.shape[1],
            flows.shape[3], nH, nW, K,
            T if T_global is None else int(T_global), ws, wt, stride0,
            int(bool(anchor)), stream)
    cuda_lib.check_launch(err, "nls_geometry_bwd")
    nls_geometry_bwd.launches += 1
    return g_flows


nls_geometry_bwd.launches = 0


def nls_geometry_bwd_plain(flows, cells, g_ph, g_pw, g_inds, **kw):
    """Plain version of G2: the flows' gradient by autograd through
    `nls_geometry_plain`. Same arguments and output as
    `nls_geometry_bwd`."""
    nls_geometry_bwd_plain.calls += 1
    with torch.enable_grad():
        f = flows.detach().requires_grad_()
        ph, pw, _, _, inds = nls_geometry_plain(f, cells, **kw)
        pairs = [(o, g) for o, g in ((ph, g_ph), (pw, g_pw), (inds, g_inds))
                 if g is not None and o.requires_grad]
        if not pairs:
            return torch.zeros_like(flows)
        g_f, = torch.autograd.grad([o for o, _ in pairs], f,
                                   [g for _, g in pairs], allow_unused=True)
    return torch.zeros_like(flows) if g_f is None else g_f


nls_geometry_bwd_plain.calls = 0


def nls_geometry(flows, cells, *, H, W, ws, wt, stride0, stride1,
                 full_ws=True, itype="float", anchor=False, query_t0=None,
                 T_global=None, halo=0):
    """The lazy route's geometry of the selected cells. flows
    [B,HDf,T,W_t(-1),2,nH,nW] (channel 0 = w, 1 = h); cells int
    [B,HD,T,nH,nW,K] flat ids (no grad). Returns (prop_h, prop_w, tj_k,
    valid, inds): the key positions [B,HD,T,nH,nW,K] (float; integers in
    the int path), the target frames (int32 from the kernel, int64 from
    the plain version), the validity mask (bool), and the offsets
    [B,HD,T,nH,nW,K,3] (float32, int32 in the int path), slot 0 zero with
    `anchor`. The positions and, in the float path, the offsets are
    differentiable in the flows."""
    kw = dict(H=H, W=W, ws=ws, wt=wt, stride0=stride0, stride1=stride1,
              full_ws=full_ws, itype=itype, anchor=anchor,
              query_t0=query_t0, T_global=T_global, halo=halo)
    if flows.device.type == "cpu":
        return nls_geometry_plain(flows, cells, **kw)
    return _Geometry.apply(flows.contiguous(), cells.contiguous(), kw)


nls_geometry.launches = 0
