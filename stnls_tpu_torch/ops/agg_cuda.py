"""B3: the NonLocalGather forward (CUDA, Hopper).

Mirrors stnls_tpu/ops/agg_pallas.py::nl_gather_stack_pallas.
`nl_gather_stack` launches csrc/agg_gather_fwd.cu on CUDA tensors inside
a torch.autograd.Function; its backward is `_gather_bwd_plain`, the VJP
of the plain version, until the hand-written gather backward (B4) lands.
It takes no budgets: it is exact for any offsets.

`nl_gather_stack_plain` is its plain PyTorch version
(ops/agg.nl_gather_stack). The wrapper takes it only for tensors on the
CPU; for a CUDA tensor it launches the kernel or raises.
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
    """Backward of the gather kernel: the VJP of `nl_gather_stack_plain`,
    recomputed under enable_grad. B4 pending: the hand-written gather
    backward kernel replaces this."""
    _gather_bwd_plain.calls += 1
    with torch.enable_grad():
        inputs = [x.detach().requires_grad_(bool(n))
                  for x, n in zip((vid, weights, flows), needs)]
        out = nl_gather_stack_plain(*inputs, **cfg)
        wanted = [x for x in inputs if x.requires_grad]
        grads = iter(torch.autograd.grad(out, wanted, g_stack)
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
        grads = _gather_bwd_plain(vid, weights, flows, g_stack, ctx.cfg,
                                  ctx.needs_input_grad[:3])
        return grads + (None,)


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
