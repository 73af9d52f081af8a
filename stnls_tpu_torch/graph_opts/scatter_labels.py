"""Slot labels for NonLocalScatter (PyTorch port of
stnls_tpu/graph_opts/scatter_labels.py; the reference's
graph_opts/scatter_labels.py and scatter_labels_kernel.cu).

Each (query, k) edge of the search graph points at a destination key
location; edges that share a destination get distinct slots `s`. The
label is the rank of the edge among all edges sharing its destination,
in edge order: one stable sort of the destinations, a running maximum
of the run starts, and the inverse permutation. The slot-count bound S
keeps the reference's allocation formula (scatter_labels.py:40-47).
"""

import torch

from stnls_tpu_torch.ops.geometry import reflect_bounds, put_dropped


def slot_bound(ws, wt, stride0, T, full_ws):
    """Max slots per destination (reference scatter_labels.py:40-47)."""
    Wt_num = T if wt > 0 else 1
    wsNum = ws // stride0 + 1
    Ws_num = wsNum * wsNum
    if full_ws:
        Ws_num += 2 * wsNum * (wsNum // 2) + (wsNum // 2) ** 2
    return Wt_num * Ws_num


def key_stride(stride1):
    """The key grid's integer stride, int(stride1) as the JAX package
    takes it. Below 1 (the search's fractional stride1, e.g. 0.5) that
    is 0, where the JAX package divides integers by zero and returns
    meaningless destinations without an error: refuse it."""
    s1 = int(stride1)
    if s1 < 1:
        raise ValueError(
            f"graph_opts: stride1={stride1} truncates to int(stride1)="
            f"{s1}, which the JAX package divides by without an error; "
            "the slot labels need an integer stride1 >= 1")
    return s1


def _dest_raster(flows_k, stride0, stride1, T, H, W):
    """Absolute destination (t,h,w) per edge -> raster index on the stride1
    key grid. flows_k [B,HD,T,nH,nW,K,3] offsets from the stride0 query
    grid (floats are rounded half to even)."""
    s1 = key_stride(stride1)
    B, HD, T_, nH, nW, K, _ = flows_k.shape
    dev = flows_k.device
    t = torch.arange(T_, device=dev)[None, None, :, None, None, None]
    h = (torch.arange(nH, device=dev) * stride0)[None, None, None, :, None,
                                                  None]
    w = (torch.arange(nW, device=dev) * stride0)[None, None, None, None, :,
                                                  None]
    fk = torch.round(flows_k).to(torch.int64) \
        if flows_k.is_floating_point() else flows_k.to(torch.int64)
    nt = reflect_bounds(t + fk[..., 0], T)
    nh = reflect_bounds(h + fk[..., 1], H)
    nw = reflect_bounds(w + fk[..., 2], W)
    nH1 = (H - 1) // s1 + 1
    nW1 = (W - 1) // s1 + 1
    q1 = (nt * nH1 + torch.div(nh, s1, rounding_mode="floor")) * nW1 \
        + torch.div(nw, s1, rounding_mode="floor")
    return q1, (nt, nh, nw)


def run(flows, flows_k, ws, wt, stride0, stride1, H, W, full_ws):
    """Returns (names, labels):
    labels [B,HD,Q,K] int32 slot per edge;
    names [B,HD,S,T,H,W,2] int32 inverse map holding (qi, ki) per (slot,
    dest) (-1 where empty), matching the reference's output contract."""
    B, HD, T, nH, nW, K, _ = flows_k.shape
    Q = T * nH * nW
    S = slot_bound(ws, wt, stride0, T, full_ws)
    dev = flows_k.device

    q1, (nt, nh, nw) = _dest_raster(flows_k, stride0, stride1, T, H, W)
    dest = q1.reshape(B, HD, Q * K)

    # rank within equal-destination runs via one stable sort
    d_sorted, order = torch.sort(dest, dim=-1, stable=True)
    idx = torch.arange(Q * K, device=dev).expand_as(dest)
    new_run = torch.ones_like(dest, dtype=torch.bool)
    new_run[..., 1:] = d_sorted[..., 1:] != d_sorted[..., :-1]
    run_start = torch.cummax(torch.where(new_run, idx, 0), dim=-1).values
    labels = torch.empty_like(dest).scatter_(-1, order, idx - run_start) \
        .reshape(B, HD, Q, K).to(torch.int32)

    # inverse names map
    names = torch.full((B, HD, S, T, H, W, 2), -1, dtype=torch.int32,
                       device=dev)
    qi = torch.arange(Q, dtype=torch.int32, device=dev) \
        .reshape(1, 1, T, nH, nW, 1).expand(B, HD, T, nH, nW, K)
    ki = torch.arange(K, dtype=torch.int32, device=dev) \
        .expand(B, HD, T, nH, nW, K)
    lab6 = labels.reshape(B, HD, T, nH, nW, K)
    bidx = torch.arange(B, device=dev)[:, None, None]
    hidx = torch.arange(HD, device=dev)[None, :, None]

    def flat(x):
        return x.reshape(B, HD, -1)

    names = put_dropped(
        names, (bidx, hidx, flat(lab6.clamp(0, S - 1)), flat(nt), flat(nh),
                flat(nw)),
        torch.stack([flat(qi), flat(ki)], -1), (B, HD, S, T, H, W))
    return names, labels


def apply(*args, **kwargs):
    return run(*args, **kwargs)
