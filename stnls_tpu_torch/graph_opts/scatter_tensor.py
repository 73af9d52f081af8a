"""Slot-indexed scatter of per-edge tensors (PyTorch port of
stnls_tpu/graph_opts/scatter_tensor.py; the reference's
graph_opts/scatter_tensor.py and scatter_tensor_kernel.cu).

scatter_tensor[b,hd,q1,s,m] = tensor[b,hd,q0,k,m] for the edge (q0,k) whose
destination is key-grid query q1 with slot label s. A plain index_put,
differentiable in `tensor` through autograd. Labels are clipped to
[0, S-1] as in the JAX package: with S below labels.max()+1 two edges
can set one element, and the last in edge order is kept, as the JAX
package keeps it on the CPU (ops/geometry.put_dropped).
"""

import math

import torch

from stnls_tpu_torch.ops.geometry import put_dropped
from stnls_tpu_torch.graph_opts.scatter_labels import _dest_raster, \
    key_stride


def slot_count(labels, S):
    """S, or labels.max()+1 (the reference's default; a host sync)."""
    return int(labels.max()) + 1 if S is None else S


def as_float(tensor):
    """Integer tensors are moved through float32, as the JAX package."""
    return tensor if tensor.is_floating_point() else tensor.float()


def to_input_dtype(out, dtype):
    """Back to the input's integer dtype the way XLA converts: saturating,
    NaN to 0."""
    if dtype.is_floating_point:
        return out
    info = torch.iinfo(dtype)
    return out.double().nan_to_num(0., info.max, info.min) \
        .clamp(info.min, info.max).to(dtype)


def run(tensor, flows_k, labels, stride0, stride1, H, W, invalid=math.inf,
        S=None):
    B, HD, T, nH0, nW0, K = tensor.shape[:6]
    Q0 = T * nH0 * nW0
    S = slot_count(labels, S)
    in_dtype = tensor.dtype
    tensor = as_float(tensor).reshape(B, HD, Q0 * K, -1)
    M = tensor.shape[-1]
    q1, _ = _dest_raster(flows_k, stride0, stride1, T, H, W)
    s1 = key_stride(stride1)
    Q1 = T * ((H - 1) // s1 + 1) * ((W - 1) // s1 + 1)
    dev = tensor.device

    out = torch.full((B, HD, Q1, S, M), invalid, dtype=tensor.dtype,
                     device=dev)
    bidx = torch.arange(B, device=dev)[:, None, None]
    hidx = torch.arange(HD, device=dev)[None, :, None]
    out = put_dropped(out, (bidx, hidx, q1.reshape(B, HD, Q0 * K),
                            labels.reshape(B, HD, Q0 * K).long()
                            .clamp(0, S - 1)),
                      tensor, (B, HD, Q1, S))
    out = to_input_dtype(out, in_dtype)
    return out[..., 0] if M == 1 else out


def apply(tensor, flows_k, labels, stride0, stride1, H, W, invalid=math.inf,
          S=None):
    return run(tensor, flows_k, labels, stride0, stride1, H, W, invalid, S)


def run_topk(weights, flows_k, labels, K, descending=True):
    """Top-K over the slot axis of scattered weights (reference
    scatter_tensor.py run_topk): weights, labels [B,HD,Q,S], flows_k
    [B,HD,Q,S,3]; ties keep slot order (a stable sort)."""
    S = flows_k.shape[3]
    if K <= 0:
        K = S
    key = -weights if descending else weights
    order = torch.sort(key, dim=-1, stable=True).indices[..., :K]
    w_k = torch.gather(weights, -1, order)
    l_k = torch.gather(labels, -1, order)
    f_k = torch.gather(flows_k, -2,
                       order[..., None].expand(order.shape + (3,)))
    return w_k, f_k, l_k
