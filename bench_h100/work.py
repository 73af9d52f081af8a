"""The yardstick of work: operations and bytes from shapes, and the
least time an NVIDIA H100 could take for them.

Frozen copies of the bring-up's arithmetic (chip_smoke.py's b1_work ...
b4_work and bound_ms, stnls_tpu_torch at PR 15), taken from shapes
alone, plus the float32 operations of a convolution. Later changes to the
program do not move these numbers: the same work is counted whatever
implements it.

Peaks: NVIDIA's data sheet for the H100 SXM at 700 W, 3.35 TB/s of HBM3
and 67 TFLOP/s of float32 outside the tensor cores.
"""

import math

HBM_BYTES_S = 3.35e12
F32_FLOP_S = 67e12
F32 = 4
# float operations per (query, slot, patch tap, channel), not any
# kernel's instruction mix. B1: bilinear read (4 mul + 3 add) + l2 (sub,
# mul, add). B2: bilinear read (7) + the cotangent 2g(p0 - pv) (sub, mul)
# + 1 add into g_vid0 + 4 corner products and 4 adds into g_vid1 + 4
# multiply-adds of the corner sums. B3: bilinear read (7) + weight and
# sum (2). B4: 8 multiply-adds of the corner sums + g * w + 4 corner
# products and 4 adds into g_vid; the division by the overlap count once
# per cotangent element.
FLOPS_PER_TAP = {"B1": 10, "B2": 26, "B3": 9, "B4": 17}


def bound_ms(nbytes, flops):
    """(ms, "bytes" or "operations"): the larger of the bytes over the
    memory rate and the operations over the float32 peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / F32_FLOP_S
    return max(t_bytes, t_ops) * 1e3, \
        "bytes" if t_bytes >= t_ops else "operations"


def taps_in_frame(n, L, ps, stride0=1):
    """(query, tap) pairs along one axis whose reference pixel lies in the
    frame: the taps the gather and its backward compute."""
    return sum(1 for q in range(n) for p in range(ps)
               if 0 <= q * stride0 + p - ps // 2 < L)


def search_shapes(B, HD, T, F, H, W, ws, wt, K):
    """(queries over the heads, window cells a query, the numel of a video
    [B,HD,T,F,H,W], of the flows [B,1,T,W_t-1,2,H,W], of dists
    [B,HD,T,H,W,K]) at stride0 = 1."""
    W_t = min(2 * wt + 1, T)
    Q = B * HD * T * H * W
    return Q, W_t * ws * ws, B * HD * T * F * H * W, \
        B * T * (W_t - 1) * 2 * H * W, Q * K


def b1_work(B, HD, T, F, H, W, *, ws, wt, ps, K):
    """B1, the search with its top-K: the videos and flows read once, the
    dists and the cells written once; FLOPS_PER_TAP per (query, window
    cell, tap, channel), every cell of the window valid (full_ws)."""
    Q, cells, vid, flows, out = search_shapes(B, HD, T, F, H, W, ws, wt, K)
    return F32 * (2 * vid + flows + 2 * out), \
        Q * cells * ps * ps * F * FLOPS_PER_TAP["B1"]


def b2_work(B, HD, T, F, H, W, *, ws, wt, ps, K, active=None):
    """B2, the search's backward: the videos, the K positions (two
    floats), the cotangent and the target frames (int32) read once, the
    two video gradients and the two position gradients written once;
    FLOPS_PER_TAP per (active (query, slot), tap, channel). `active`
    defaults to every (query, slot): the pairs whose cotangent is not 0,
    where a run counts them."""
    Q, _, vid, _, out = search_shapes(B, HD, T, F, H, W, ws, wt, K)
    active = out if active is None else active
    read = 2 * vid + 2 * out + out + out
    written = 2 * vid + 2 * out
    return F32 * (read + written), \
        active * ps * ps * F * FLOPS_PER_TAP["B2"]


def b3_work(B, HD, T, F, H, W, *, ps, K, stride0=1):
    """B3, the gather: video, weights and offsets (3 floats) read once,
    the stack [B,HD,K,T,F,H,W] written once; FLOPS_PER_TAP per (output
    pixel, slot, in-frame tap, channel) and the division once per
    output."""
    nH, nW = (H - 1) // stride0 + 1, (W - 1) // stride0 + 1
    vid = B * HD * T * F * H * W
    w = B * HD * T * nH * nW * K
    out = B * HD * K * T * F * H * W
    taps = taps_in_frame(nH, H, ps, stride0) * taps_in_frame(
        nW, W, ps, stride0) * B * HD * T * K
    return F32 * (vid + w + 3 * w + out), \
        taps * F * FLOPS_PER_TAP["B3"] + out


def b4_work(B, HD, T, F, H, W, *, ps, K, stride0=1):
    """B4, the gather's backward: video, weights, offsets and the stack's
    cotangent read once, the gradients of the video, weights and offsets
    written once; FLOPS_PER_TAP per (query, slot, in-frame tap, channel)
    and the division by the overlap count once per cotangent element."""
    nH, nW = (H - 1) // stride0 + 1, (W - 1) // stride0 + 1
    vid = B * HD * T * F * H * W
    w = B * HD * T * nH * nW * K
    g = B * HD * K * T * F * H * W
    taps = taps_in_frame(nH, H, ps, stride0) * taps_in_frame(
        nW, W, ps, stride0) * B * HD * T * K
    return F32 * (2 * (vid + w + 3 * w) + g), \
        taps * F * FLOPS_PER_TAP["B4"] + g


def conv_flops(N, H, W, c_in, c_out, k):
    """A k x k convolution over N frames of H x W at stride 1 and "same"
    padding: a multiply and an add per weight and output pixel."""
    return 2 * N * H * W * c_in * c_out * k * k


def conv_step_flops(N, H, W, c_in, c_out, k, backward, input_grad=True):
    """The forward's operations, and with `backward` those of the weight
    gradient and (unless the input needs none) of the input gradient,
    each as many as the forward."""
    f = conv_flops(N, H, W, c_in, c_out, k)
    if not backward:
        return f
    return f + f + (f if input_grad else 0)


def share(bound, measured_ms):
    """A share of the roofline in %, or None where nothing was measured."""
    if not measured_ms or measured_ms <= 0 or not math.isfinite(
            measured_ms):
        return None
    return 100. * bound / measured_ms


def kernel_share(ctx, key):
    """The roofline share in % of the port's kernel `key` in a traced run:
    its bound from the cell's work over its device ms a step; None where
    the cell has no such work or the trace shows no such kernel."""
    if key not in ctx["work"]:
        return None
    return share(bound_ms(*ctx["work"][key])[0],
                 ctx["trace"].layer_ms_per_step(key))
