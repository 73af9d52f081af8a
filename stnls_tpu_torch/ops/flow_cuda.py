"""F1 and F2: the search-flow walk in one launch, and its flow backward
(CUDA, Hopper).

`search_flow` composes the per-frame flows fflow/bflow [B,T,2,H,W] into
the W_t-1 search-window offsets [B,T,W_t-1,2,nH,nW] that
ops/flow_ops.search_flow returns. On CUDA float32 tensors it launches
csrc/search_flow.cu: F1 walks every slot of every query in registers and
writes each offset once, bitwise equal to the plain walk on the same card;
F2, its backward, gives fflow and bflow their gradients (only to the ones
that require one). The plain version is ops/flow_ops.search_flow_plain,
which flow_ops.search_flow runs on CPU tensors; `search_flow_bwd_plain`,
autograd through it, is F2's.
"""

import torch

from stnls_tpu_torch.ops import cuda_lib
from stnls_tpu_torch.ops.geometry import num_queries


def _check(fflow, bflow, wt, stride0):
    """Raise on what F1 and F2 do not take; returns (B, T, H, W, nH, nW,
    S), S = W_t - 1 slots."""
    if fflow.device.type != "cuda" or bflow.device != fflow.device:
        raise ValueError("search_flow: fflow and bflow must be on one CUDA "
                         "device")
    if fflow.dtype != torch.float32 or bflow.dtype != torch.float32:
        raise TypeError(f"search_flow: float32 flows, got {fflow.dtype} and "
                        f"{bflow.dtype}")
    if fflow.ndim != 5 or fflow.shape[2] != 2 or bflow.shape != fflow.shape:
        raise ValueError(f"search_flow: fflow and bflow [B,T,2,H,W] of one "
                         f"shape, got {tuple(fflow.shape)} and "
                         f"{tuple(bflow.shape)}")
    if wt < 1 or stride0 < 1:
        raise ValueError("search_flow: need wt >= 1 and stride0 >= 1")
    B, T, _, H, W = fflow.shape
    return (B, T, H, W) + num_queries(H, W, stride0) \
        + (min(2 * wt + 1, T) - 1,)


def search_flow_fwd(fflow, bflow, wt, stride0):
    """F1's launch; see `search_flow`."""
    B, T, H, W, nH, nW, S = _check(fflow, bflow, wt, stride0)
    out = torch.empty((B, T, S, 2, nH, nW), dtype=torch.float32,
                      device=fflow.device)
    if out.numel() == 0:
        return out
    lib = cuda_lib.load()
    with torch.cuda.device(fflow.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.stnls_search_flow_fwd(
            fflow.data_ptr(), bflow.data_ptr(), out.data_ptr(), B, T, H, W,
            nH, nW, wt, stride0, stream)
    cuda_lib.check_launch(err, "search_flow")
    search_flow.launches += 1
    return out


def search_flow_bwd(fflow, bflow, g_out, wt, stride0, need=(True, True)):
    """F2: (g_fflow, g_bflow) from the offsets' cotangent g_out
    [B,T,W_t-1,2,nH,nW]; a flow whose entry of `need` is False gets
    None."""
    B, T, H, W, nH, nW, S = _check(fflow, bflow, wt, stride0)
    g_out = g_out.contiguous()
    if tuple(g_out.shape) != (B, T, S, 2, nH, nW) or \
            g_out.dtype != torch.float32 or g_out.device != fflow.device:
        raise ValueError(f"search_flow_bwd: the cotangent must be float32 "
                         f"{(B, T, S, 2, nH, nW)} on the flows' device, got "
                         f"{g_out.dtype} {tuple(g_out.shape)}")
    grads = [torch.zeros_like(f) if n else None
             for f, n in zip((fflow, bflow), need)]
    if g_out.numel() == 0 or not any(need):
        return tuple(grads)
    lib = cuda_lib.load()
    with torch.cuda.device(fflow.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.stnls_search_flow_bwd(
            fflow.data_ptr(), bflow.data_ptr(), g_out.data_ptr(),
            *(None if g is None else g.data_ptr() for g in grads),
            B, T, H, W, nH, nW, wt, stride0, stream)
    cuda_lib.check_launch(err, "search_flow_bwd")
    search_flow_bwd.launches += 1
    return tuple(grads)


search_flow_bwd.launches = 0


def search_flow_bwd_plain(fflow, bflow, g_out, wt, stride0,
                          need=(True, True)):
    """Plain version of F2: autograd through flow_ops.search_flow_plain.
    Same arguments and outputs as `search_flow_bwd`."""
    from stnls_tpu_torch.ops.flow_ops import search_flow_plain
    search_flow_bwd_plain.calls += 1
    flows = [f.detach().requires_grad_(bool(n))
             for f, n in zip((fflow, bflow), need)]
    wanted = [f for f in flows if f.requires_grad]
    if not wanted:
        return None, None
    with torch.enable_grad():
        out = search_flow_plain(*flows, wt, stride0)
        grads = iter(torch.autograd.grad(out, wanted, g_out))
    return tuple(next(grads) if f.requires_grad else None for f in flows)


search_flow_bwd_plain.calls = 0


class _SearchFlow(torch.autograd.Function):
    """Forward: F1. Backward: F2, into the flows that need a gradient."""

    @staticmethod
    def forward(ctx, fflow, bflow, wt, stride0):
        ctx.save_for_backward(fflow, bflow)
        ctx.wt, ctx.stride0 = wt, stride0
        return search_flow_fwd(fflow, bflow, wt, stride0)

    @staticmethod
    def backward(ctx, g_out):
        fflow, bflow = ctx.saved_tensors
        g_f, g_b = search_flow_bwd(fflow, bflow, g_out, ctx.wt, ctx.stride0,
                                   need=ctx.needs_input_grad[:2])
        return g_f, g_b, None, None


def search_flow(fflow, bflow, wt, stride0=1):
    """The W_t-1 search-window offsets [B,T,W_t-1,2,nH,nW] of fflow/bflow
    [B,T,2,H,W] (CUDA float32, wt >= 1), differentiable in both."""
    return _SearchFlow.apply(fflow.contiguous(), bflow.contiguous(), int(wt),
                             int(stride0))


search_flow.launches = 0
