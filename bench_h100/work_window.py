"""Operations and bytes of the window kernels that work.py does not
count: the full search volume B5, its backward B6, the pooled weighted
sum B9 and its backward B10, from shapes alone.

Frozen copies of chip_smoke.py's counts (its B5/B6 check and
sp_forward_bound, the B10 bound beside it), at ps 1, one frame (W_t 1)
and every window cell inside the frame (full_ws), as the pool's and the
search's arguments give them; the bound is work.bound_ms. Where they
differ from chip_smoke's:
  * the search in the int path (integer offsets) reads the key at one
    pixel: 2 operations a (query, cell, channel) for B5 (the product and
    its add), 4 for B6 (the two cotangent products and their adds), where
    chip_smoke counts the float path's bilinear read (10 and 26);
  * B9's and B10's live terms are counted from shapes (a live weight in
    each (query, slot) of the unpadded map), not from the run's weights.
"""

from bench_h100.work import F32

FLOPS_PER_TAP_INT = {"B5": 2, "B6": 4}
FLOPS_PER_TAP = {"B9": 2, "B10": 4}


def b5_work(B, HD, F, H, W, *, ws):
    """B5 at stride0 1, ps 1, W_t 1: both videos and the two centre maps
    read once, the volume [B,HD,1,1,ws,ws,H,W] written once; every
    (query, cell, channel) summed."""
    vid, ctr, vol = B * HD * F * H * W, B * HD * H * W, B * HD * ws * ws * H * W
    return F32 * (2 * vid + 2 * ctr + vol), \
        vol * F * FLOPS_PER_TAP_INT["B5"]


def b6_work(B, HD, F, H, W, *, ws):
    """B6: B5's inputs and the volume's cotangent read once, the two video
    gradients and the two centre gradients written once; every (query,
    cell) active."""
    vid, ctr, vol = B * HD * F * H * W, B * HD * H * W, B * HD * ws * ws * H * W
    return F32 * (2 * vid + 2 * ctr + vol + 2 * vid + 2 * ctr), \
        vol * F * FLOPS_PER_TAP_INT["B6"]


def b9_work(B, HD, F, H, W, *, K, live):
    """B9 at ps 1, stride0 1 on an H x W map: the video, the weights and
    the offsets (3 floats) read once, the output (the video's size)
    written once; FLOPS_PER_TAP per live (query, slot) and channel, and
    the division once per output element."""
    vid, w = B * HD * F * H * W, B * HD * H * W * K
    return F32 * (vid + w + 3 * w + vid), \
        live * F * FLOPS_PER_TAP["B9"] + vid


def b10_work(B, HD, F, H, W, *, K, live):
    """B10: B9's inputs and the output's cotangent read once, the video's
    and the weights' gradients written once; FLOPS_PER_TAP per live
    (query, slot) and channel, and the cotangent's division once per
    element."""
    vid, w = B * HD * F * H * W, B * HD * H * W * K
    return F32 * (vid + w + 3 * w + vid + vid + w), \
        live * F * FLOPS_PER_TAP["B10"] + vid
