"""B7-B10: the NonLocalScatterAdd and PooledPatchSum forwards and
backwards (CUDA, Hopper).

Mirror stnls_tpu/ops/agg_pallas_sp.py: `nl_scatter_add` launches
csrc/agg_scatter_add_fwd.cu (B7) inside a torch.autograd.Function whose
backward, `nl_scatter_add_bwd`, launches csrc/agg_scatter_add_bwd.cu (B8);
`nl_pool` launches csrc/agg_pool_fwd.cu (B9), its backward `nl_pool_bwd`
csrc/agg_pool_bwd.cu (B10). Both ops round the offsets (half to even), so
the offsets get a zero gradient. The kernels take strides, output size,
dilation, use_adj, pt and reflect_bounds at run time and are exact for
any offsets, so every configuration of the engines runs on them.

`nl_scatter_add_plain` and `nl_pool_plain` (ops/agg.nl_scatter_add,
nl_pool) and `_scatter_add_bwd_plain`, `_pool_bwd_plain` (their VJPs) are
the kernels' plain PyTorch versions. The wrappers take them only for
tensors on the CPU; for a CUDA tensor they launch the kernel or raise.
`scatter_add_counts` (the reference's counts quirk) is plain torch.
"""

import torch

from stnls_tpu_torch.ops import cuda_lib
from stnls_tpu_torch.ops.agg import nl_scatter_add as _nl_scatter_add, \
    nl_pool as _nl_pool, default_out_size, scatter_add_counts  # noqa: F401
from stnls_tpu_torch.ops.geometry import num_queries


def nl_scatter_add_plain(vid, weights, flows, *, ps, strideIn, strideOut,
                         pt=1, dilation=1, reflect_bounds=True,
                         use_adj=False, outH=0, outW=0):
    """Plain version of B7. Same arguments and output as
    `nl_scatter_add`."""
    return _nl_scatter_add(vid, weights, flows, ps=ps, strideIn=strideIn,
                           strideOut=strideOut, pt=pt, dilation=dilation,
                           reflect_bounds_=reflect_bounds, use_adj=use_adj,
                           outH=outH, outW=outW)[0]


def nl_pool_plain(vid, weights, flows, *, ps, stride0, pt=1, dilation=1,
                  reflect_bounds=True, use_adj=False):
    """Plain version of B9. Same arguments and output as `nl_pool`."""
    return _nl_pool(vid, weights, flows, ps=ps, stride0=stride0, pt=pt,
                    dilation=dilation, reflect_bounds_=reflect_bounds,
                    use_adj=use_adj)


def _vjp_plain(plain, vid, weights, flows, g_out, cfg, needs):
    """The VJP of `plain` at (vid, weights, flows), recomputed under
    enable_grad: (g_vid, g_weights, g_flows), each None where `needs` says
    so; the rounded offsets get zeros."""
    with torch.enable_grad():
        v = vid.detach().requires_grad_(bool(needs[0]))
        w = weights.detach().requires_grad_(bool(needs[1]))
        wanted = [x for x in (v, w) if x.requires_grad]
        grads = iter(torch.autograd.grad(
            plain(v, w, flows.detach(), **cfg), wanted, g_out,
            allow_unused=True, materialize_grads=True) if wanted else ())
    g_vid = next(grads) if needs[0] else None
    g_w = next(grads) if needs[1] else None
    return g_vid, g_w, torch.zeros_like(flows) if needs[2] else None


def _scatter_add_bwd_plain(vid, weights, flows, g_out, cfg, needs):
    """Plain version of B8: the VJP of `nl_scatter_add_plain`. Same
    arguments and outputs as `nl_scatter_add_bwd`."""
    _scatter_add_bwd_plain.calls += 1
    return _vjp_plain(nl_scatter_add_plain, vid, weights, flows, g_out, cfg,
                      needs)


def _pool_bwd_plain(vid, weights, flows, g_out, cfg, needs):
    """Plain version of B10: the VJP of `nl_pool_plain`. Same arguments and
    outputs as `nl_pool_bwd`."""
    _pool_bwd_plain.calls += 1
    return _vjp_plain(nl_pool_plain, vid, weights, flows, g_out, cfg, needs)


_scatter_add_bwd_plain.calls = 0
_pool_bwd_plain.calls = 0


def _check(name, vid, weights, flows, stride, cfg):
    for what, x in (("vid", vid), ("weights", weights), ("flows", flows)):
        if x.device.type != "cuda" or x.device != vid.device:
            raise ValueError(f"{name}: {what} must be on vid's CUDA device")
        if x.dtype != torch.float32:
            raise TypeError(f"{name}: {what} must be float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    if vid.ndim != 6:
        raise ValueError(f"{name}: vid must be [B,HD,T,F,H,W]")
    B, HD, T, F, H, W = vid.shape
    nH, nW = num_queries(H, W, stride)
    K = flows.shape[-2]
    if (tuple(weights.shape) != (B, HD, T, nH, nW, K)
            or tuple(flows.shape) != (B, HD, T, nH, nW, K, 3)):
        raise ValueError(f"{name}: weights [B,HD,T,nH,nW,K] and flows "
                         "[B,HD,T,nH,nW,K,3] expected, got "
                         f"{tuple(weights.shape)}, {tuple(flows.shape)}")
    if int(cfg["dilation"]) != cfg["dilation"] or cfg["dilation"] < 1:
        raise ValueError(f"{name}: dilation must be an integer >= 1")
    if min(cfg["ps"], stride, cfg["pt"]) < 1:
        raise ValueError(f"{name}: need ps, strides and pt >= 1")


def _check_cotangent(name, vid, g_out, shape):
    if tuple(g_out.shape) != shape or g_out.dtype != torch.float32 or \
            g_out.device != vid.device:
        raise ValueError(f"{name}: the cotangent must be float32 {shape} on "
                         f"vid's device, got {tuple(g_out.shape)} "
                         f"{g_out.dtype}")


def _launch(fn, name, *args):
    """Call the C entry `fn` with the tensors' pointers, ints and the
    current stream of the first tensor's device; raise on a CUDA error."""
    dev = args[0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a
                   for a in args), stream)
    cuda_lib.check_launch(err, name)


# ---------------------------------------------------------------------------
# ScatterAdd (B7, B8)
# ---------------------------------------------------------------------------

def _scatter_ints(vid, flows, cfg):
    B, HD, T, F, H, W = vid.shape
    nH, nW = num_queries(H, W, cfg["strideIn"])
    return (B, HD, flows.shape[-2], T, F, H, W, nH, nW, cfg["outH"],
            cfg["outW"], cfg["ps"], cfg["strideIn"], cfg["strideOut"],
            cfg["pt"], int(cfg["dilation"]), int(bool(cfg["reflect_bounds"])),
            int(bool(cfg["use_adj"])))


class _ScatterAdd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, vid, weights, flows, cfg):
        B, HD, T, F = vid.shape[:4]
        out = torch.zeros((B, HD, T, F, cfg["outH"], cfg["outW"]),
                          dtype=torch.float32, device=vid.device)
        _launch(cuda_lib.load().stnls_agg_scatter_add_fwd, "nl_scatter_add",
                vid, weights, flows, out, *_scatter_ints(vid, flows, cfg))
        nl_scatter_add.launches += 1
        ctx.save_for_backward(vid, weights, flows)
        ctx.cfg = cfg
        return out

    @staticmethod
    def backward(ctx, g_out):
        vid, weights, flows = ctx.saved_tensors
        grads = nl_scatter_add_bwd(vid, weights, flows, g_out, ctx.cfg,
                                   ctx.needs_input_grad[:3])
        return grads + (None,)


def nl_scatter_add_bwd(vid, weights, flows, g_out, cfg, needs):
    """B8. The gradients of `nl_scatter_add` (cfg: its keywords, the output
    size resolved) from the output cotangent g_out [B,HD,T,F,outH,outW]:
    (g_vid, g_weights, g_flows), each None where `needs` says so; g_flows
    is 0 (the offsets are rounded)."""
    if vid.device.type == "cpu":
        return _scatter_add_bwd_plain(vid, weights, flows, g_out, cfg, needs)
    _check("nl_scatter_add_bwd", vid, weights, flows, cfg["strideIn"], cfg)
    B, HD, T, F = vid.shape[:4]
    _check_cotangent("nl_scatter_add_bwd", vid, g_out,
                     (B, HD, T, F, cfg["outH"], cfg["outW"]))
    g_vid, g_w = torch.empty_like(vid), torch.empty_like(weights)
    _launch(cuda_lib.load().stnls_agg_scatter_add_bwd, "nl_scatter_add_bwd",
            vid, weights, flows, g_out.contiguous(), g_vid, g_w,
            *_scatter_ints(vid, flows, cfg), int(bool(needs[0])),
            int(bool(needs[1])))
    nl_scatter_add_bwd.launches += 1
    return (g_vid if needs[0] else None, g_w if needs[1] else None,
            torch.zeros_like(flows) if needs[2] else None)


nl_scatter_add_bwd.launches = 0


def nl_scatter_add(vid, weights, flows, *, ps, strideIn, strideOut, pt=1,
                   dilation=1, reflect_bounds=True, use_adj=False, outH=0,
                   outW=0):
    """NonLocalScatterAdd. vid [B,HD,T,F,H,W]; weights [B,HD,T,nH,nW,K]
    and flows [B,HD,T,nH,nW,K,3] as (dt, dh, dw) on the strideIn grid ->
    out [B,HD,T,F,outH,outW], unnormalised (outH, outW: 0 for the
    default). Differentiable in vid and weights."""
    H, W = vid.shape[-2:]
    nH, nW = num_queries(H, W, strideIn)
    outH, outW = default_out_size(H, W, nH, nW, strideOut, outH, outW)
    cfg = dict(ps=ps, strideIn=strideIn, strideOut=strideOut, pt=pt,
               dilation=dilation, reflect_bounds=reflect_bounds,
               use_adj=use_adj, outH=outH, outW=outW)
    if vid.device.type == "cpu":
        return nl_scatter_add_plain(vid, weights, flows, **cfg)
    _check("nl_scatter_add", vid, weights, flows, strideIn, cfg)
    return _ScatterAdd.apply(vid, weights, flows, cfg)


nl_scatter_add.launches = 0


# ---------------------------------------------------------------------------
# PooledPatchSum (B9, B10)
# ---------------------------------------------------------------------------

def _pool_ints(vid, flows, cfg):
    B, HD, T, F, H, W = vid.shape
    nH, nW = num_queries(H, W, cfg["stride0"])
    ps = cfg["ps"] + (1 - cfg["ps"] % 2)             # forced odd
    return (B, HD, flows.shape[-2], T, F, H, W, nH, nW, ps, cfg["stride0"],
            cfg["pt"], int(cfg["dilation"]), int(bool(cfg["reflect_bounds"])),
            int(bool(cfg["use_adj"])))


def _pool_out_shape(vid, cfg):
    B, HD, T, F, H, W = vid.shape
    nH, nW = num_queries(H, W, cfg["stride0"])
    ps = cfg["ps"] + (1 - cfg["ps"] % 2)
    return (B, HD, T, F, ps * nH, ps * nW)


class _Pool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, vid, weights, flows, cfg):
        out = torch.empty(_pool_out_shape(vid, cfg), dtype=torch.float32,
                          device=vid.device)
        _launch(cuda_lib.load().stnls_agg_pool_fwd, "nl_pool", vid, weights,
                flows, out, *_pool_ints(vid, flows, cfg))
        nl_pool.launches += 1
        ctx.save_for_backward(vid, weights, flows)
        ctx.cfg = cfg
        return out

    @staticmethod
    def backward(ctx, g_out):
        vid, weights, flows = ctx.saved_tensors
        grads = nl_pool_bwd(vid, weights, flows, g_out, ctx.cfg,
                            ctx.needs_input_grad[:3])
        return grads + (None,)


def nl_pool_bwd(vid, weights, flows, g_out, cfg, needs):
    """B10. The gradients of `nl_pool` (cfg: its keywords) from the output
    cotangent g_out [B,HD,T,F,ps*nH,ps*nW] (ps forced odd): (g_vid,
    g_weights, g_flows), each None where `needs` says so; g_flows is 0
    (the offsets are rounded)."""
    if vid.device.type == "cpu":
        return _pool_bwd_plain(vid, weights, flows, g_out, cfg, needs)
    _check("nl_pool_bwd", vid, weights, flows, cfg["stride0"], cfg)
    _check_cotangent("nl_pool_bwd", vid, g_out, _pool_out_shape(vid, cfg))
    g_vid, g_w = torch.zeros_like(vid), torch.empty_like(weights)
    _launch(cuda_lib.load().stnls_agg_pool_bwd, "nl_pool_bwd", vid, weights,
            flows, g_out.contiguous(), g_vid, g_w,
            *_pool_ints(vid, flows, cfg), int(bool(needs[0])))
    nl_pool_bwd.launches += 1
    return (g_vid if needs[0] else None, g_w if needs[1] else None,
            torch.zeros_like(flows) if needs[2] else None)


nl_pool_bwd.launches = 0


def nl_pool(vid, weights, flows, *, ps, stride0, pt=1, dilation=1,
            reflect_bounds=True, use_adj=False):
    """PooledPatchSum. vid [B,HD,T,F,H,W]; weights [B,HD,T,nH,nW,K] and
    flows [B,HD,T,nH,nW,K,3] on the stride0 grid -> out
    [B,HD,T,F,ps*nH,ps*nW] with ps forced odd. Differentiable in vid and
    weights."""
    cfg = dict(ps=ps, stride0=stride0, pt=pt, dilation=dilation,
               reflect_bounds=reflect_bounds, use_adj=use_adj)
    if vid.device.type == "cpu":
        return nl_pool_plain(vid, weights, flows, **cfg)
    _check("nl_pool", vid, weights, flows, stride0, cfg)
    return _Pool.apply(vid, weights, flows, cfg)


nl_pool.launches = 0
