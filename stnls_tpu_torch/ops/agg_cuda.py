"""B3 and B4: the NonLocalGather forward and backward (CUDA, Hopper).

Mirror stnls_tpu/ops/agg_pallas.py::nl_gather_stack_pallas and the
backward of its custom_vjp `_agg_op`, agg_pallas_bwd.py::agg_bwd_pallas.
`nl_gather_stack` launches csrc/agg_gather_fwd.cu (B3) on CUDA tensors
inside a torch.autograd.Function whose backward, `nl_gather_stack_bwd`,
launches csrc/agg_gather_bwd.cu (B4). They take no budgets: they are
exact for any offsets.

`nl_gather_stack_plain` (ops/agg.nl_gather_stack) and `_gather_bwd_plain`
(its VJP) are the kernels' plain PyTorch versions. The wrappers take them
only for tensors on the CPU; for a CUDA tensor they launch the kernel or
raise.
"""

import torch

from stnls_tpu_torch.ops import cuda_lib
from stnls_tpu_torch.ops.agg import nl_gather_stack as _nl_gather_stack
from stnls_tpu_torch.ops.geometry import num_queries


def nl_gather_stack_plain(vid, weights, flows, *, ps, stride0, pt=1,
                          dilation=1, reflect_bounds=True, use_adj=False,
                          itype="float"):
    """Plain version of B3. Same arguments and output as `nl_gather_stack`."""
    return _nl_gather_stack(vid, weights, flows, ps=ps, stride0=stride0,
                            pt=pt, dilation=dilation,
                            reflect_bounds_=reflect_bounds, use_adj=use_adj,
                            itype=itype)


def _gather_bwd_plain(vid, weights, flows, g_stack, cfg, needs):
    """Plain version of B4: the VJP of `nl_gather_stack_plain`, recomputed
    under enable_grad. Same arguments and outputs as
    `nl_gather_stack_bwd`."""
    _gather_bwd_plain.calls += 1
    with torch.enable_grad():
        inputs = [x.detach().requires_grad_(bool(n))
                  for x, n in zip((vid, weights, flows), needs)]
        out = nl_gather_stack_plain(*inputs, **cfg)
        wanted = [x for x in inputs if x.requires_grad]
        # int offsets are rounded and cast: they get no gradient
        grads = iter(torch.autograd.grad(out, wanted, g_stack,
                                         allow_unused=True,
                                         materialize_grads=True)
                     if wanted else ())
    return tuple(next(grads) if x.requires_grad else None for x in inputs)


_gather_bwd_plain.calls = 0


def _check(vid, weights, flows, *, ps, stride0, pt, reflect_bounds, dilation,
           itype):
    for name, x in (("vid", vid), ("weights", weights), ("flows", flows)):
        if x.device.type != "cuda" or x.device != vid.device:
            raise ValueError(f"nl_gather_stack: {name} must be on vid's "
                             "CUDA device")
        if x.dtype != torch.float32:
            raise TypeError(f"nl_gather_stack: {name} must be float32, "
                            f"got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"nl_gather_stack: {name} must be contiguous")
    if vid.ndim != 6:
        raise ValueError("nl_gather_stack: vid must be [B,HD,T,F,H,W]")
    B, HD, T, F, H, W = vid.shape
    nH, nW = num_queries(H, W, stride0)
    K = flows.shape[-2]
    if (tuple(weights.shape) != (B, HD, T, nH, nW, K)
            or tuple(flows.shape) != (B, HD, T, nH, nW, K, 3)):
        raise ValueError("nl_gather_stack: weights [B,HD,T,nH,nW,K] and "
                         "flows [B,HD,T,nH,nW,K,3] expected, got "
                         f"{tuple(weights.shape)}, {tuple(flows.shape)}")
    if not reflect_bounds:
        raise NotImplementedError(
            "nl_gather_stack kernel: reflect_bounds=False is not yet "
            "ported, see ROADMAP")
    if int(dilation) != dilation or dilation < 1:
        raise NotImplementedError("nl_gather_stack: integer dilation only")
    if ps < 1 or stride0 < 1 or pt < 1 or itype not in ("float", "int"):
        raise ValueError("nl_gather_stack: need ps, stride0, pt >= 1 and "
                         "itype in ('float', 'int')")


class _GatherStack(torch.autograd.Function):
    @staticmethod
    def forward(ctx, vid, weights, flows, cfg):
        B, HD, T, F, H, W = vid.shape
        nH, nW = num_queries(H, W, cfg["stride0"])
        K = flows.shape[-2]
        out = torch.empty((B, HD, K, T, F, H, W), dtype=torch.float32,
                          device=vid.device)
        lib = cuda_lib.load()
        with torch.cuda.device(vid.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.stnls_agg_gather_fwd(
                vid.data_ptr(), weights.data_ptr(), flows.data_ptr(),
                out.data_ptr(), B, HD, K, T, F, H, W, nH, nW, cfg["ps"],
                cfg["stride0"], cfg["pt"], int(cfg["dilation"]),
                int(bool(cfg["use_adj"])), int(cfg["itype"] == "int"),
                stream)
        cuda_lib.check_launch(err, "nl_gather_stack")
        nl_gather_stack.launches += 1
        ctx.save_for_backward(vid, weights, flows)
        ctx.cfg = cfg
        return out

    @staticmethod
    def backward(ctx, g_stack):
        vid, weights, flows = ctx.saved_tensors
        grads = nl_gather_stack_bwd(vid, weights, flows, g_stack, ctx.cfg,
                                    ctx.needs_input_grad[:3])
        return grads + (None,)


def nl_gather_stack_bwd(vid, weights, flows, g_stack, cfg, needs):
    """B4. The gradients of `nl_gather_stack` (cfg: its keywords) from the
    stack cotangent g_stack [B,HD,K,T,F,H,W]: (g_vid, g_weights, g_flows),
    each None where `needs` says so; g_flows has 0 in dt and in the int
    path."""
    if vid.device.type == "cpu":
        return _gather_bwd_plain(vid, weights, flows, g_stack, cfg, needs)
    _check(vid, weights, flows, ps=cfg["ps"], stride0=cfg["stride0"],
           pt=cfg["pt"], reflect_bounds=cfg["reflect_bounds"],
           dilation=cfg["dilation"], itype=cfg["itype"])
    B, HD, T, F, H, W = vid.shape
    nH, nW = num_queries(H, W, cfg["stride0"])
    K = flows.shape[-2]
    if tuple(g_stack.shape) != (B, HD, K, T, F, H, W) or \
            g_stack.dtype != torch.float32 or g_stack.device != vid.device:
        raise ValueError("nl_gather_stack_bwd: g_stack must be float32 "
                         f"[B,HD,K,T,F,H,W] on vid's device, got "
                         f"{tuple(g_stack.shape)} {g_stack.dtype}")
    g_stack = g_stack.contiguous()
    g_vid = torch.zeros_like(vid)
    g_weights = torch.empty_like(weights)
    g_flows = torch.empty_like(flows)
    lib = cuda_lib.load()
    with torch.cuda.device(vid.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.stnls_agg_gather_bwd(
            vid.data_ptr(), weights.data_ptr(), flows.data_ptr(),
            g_stack.data_ptr(), g_vid.data_ptr(), g_weights.data_ptr(),
            g_flows.data_ptr(), B, HD, K, T, F, H, W, nH, nW, cfg["ps"],
            cfg["stride0"], cfg["pt"], int(cfg["dilation"]),
            int(bool(cfg["use_adj"])), int(cfg["itype"] == "int"), stream)
    cuda_lib.check_launch(err, "nl_gather_stack_bwd")
    nl_gather_stack_bwd.launches += 1
    return tuple(g if n else None
                 for g, n in zip((g_vid, g_weights, g_flows), needs))


nl_gather_stack_bwd.launches = 0


def nl_gather_stack(vid, weights, flows, *, ps, stride0, pt=1, dilation=1,
                    reflect_bounds=True, use_adj=False, itype="float"):
    """NonLocalGather stack. vid [B,HD,T,F,H,W]; weights [B,HD,T,nH,nW,K];
    flows [B,HD,T,nH,nW,K,3] as (dt, dh, dw) -> stack [B,HD,K,T,F,H,W],
    count-normalised. Differentiable in vid, weights and (float) flows."""
    cfg = dict(ps=ps, stride0=stride0, pt=pt, dilation=dilation,
               reflect_bounds=reflect_bounds, use_adj=use_adj, itype=itype)
    if vid.device.type == "cpu":
        return nl_gather_stack_plain(vid, weights, flows, **cfg)
    if itype == "int":
        flows = torch.round(flows)
    _check(vid, weights, flows, ps=ps, stride0=stride0, pt=pt,
           reflect_bounds=reflect_bounds, dilation=dilation, itype=itype)
    return _GatherStack.apply(vid, weights, flows, cfg)


nl_gather_stack.launches = 0
