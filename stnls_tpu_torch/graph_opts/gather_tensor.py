"""Inverse gather by slot labels (PyTorch port of
stnls_tpu/graph_opts/gather_tensor.py; the reference's
graph_opts/gather_tensor.py ships broken, with a stray exit(), and this
completes its documented contract).

gather_tensor[b,hd,q0,s,m] = tensor[b,hd,q1,k,m] where (q0,k) is the edge
with slot label s whose destination is key-grid query q1. Labels are
unique among a destination's edges, not among a query's: two edges of one
query can share a label (and more with S below labels.max()+1, where
labels are clipped to [0, S-1] as in scatter_tensor); the last in edge
order is kept, as the JAX package keeps it on the CPU.
"""

import math

import torch

from stnls_tpu_torch.ops.geometry import put_dropped
from stnls_tpu_torch.graph_opts.scatter_labels import _dest_raster, \
    key_stride
from stnls_tpu_torch.graph_opts.scatter_tensor import slot_count, \
    as_float, to_input_dtype


def run(tensor, flows_k, labels, stride0, stride1, H, W, invalid=math.inf,
        S=None):
    B, HD, T, nH, nW, K = flows_k.shape[:6]
    Q0 = T * nH * nW
    S = slot_count(labels, S)
    s1 = key_stride(stride1)
    Q1 = T * ((H - 1) // s1 + 1) * ((W - 1) // s1 + 1)
    in_dtype = tensor.dtype
    tensor = as_float(tensor).reshape(B, HD, Q1, K, -1)
    M = tensor.shape[-1]
    dev = tensor.device

    q1, _ = _dest_raster(flows_k, stride0, stride1, T, H, W)
    # value at edge = tensor[q1, k] (a gather clamps its index, as XLA's)
    q1 = q1.reshape(B, HD, Q0, K).clamp(0, Q1 - 1)
    vals = torch.gather(tensor, 2, q1[..., None].expand(B, HD, Q0, K, M))

    out = torch.full((B, HD, Q0, S, M), invalid, dtype=tensor.dtype,
                     device=dev)
    bidx = torch.arange(B, device=dev)[:, None, None]
    hidx = torch.arange(HD, device=dev)[None, :, None]
    q0 = torch.arange(Q0, device=dev)[:, None].expand(Q0, K).reshape(1, 1, -1)
    out = put_dropped(out, (bidx, hidx, q0,
                            labels.reshape(B, HD, Q0 * K).long()
                            .clamp(0, S - 1)),
                      vals.reshape(B, HD, Q0 * K, M), (B, HD, Q0, S))
    out = to_input_dtype(out, in_dtype)
    return out[..., 0] if M == 1 else out


def apply(*args, **kwargs):
    return run(*args, **kwargs)
