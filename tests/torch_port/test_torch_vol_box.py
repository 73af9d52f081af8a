"""The box of B6's measured box variant (b5_b6_variants.box_extent,
box_side; csrc/variants/nls_vol_bwd_box.cu) and the channels-last layout
B2, B5 and B6 share (ops/cuda_lib.channel_layout, channels_last_pair), on
the CPU.

The box extent is held against the integer corners that the plain volume
(ops/nls.lattice_search) reads for each (query, slot) on seeded flows:
every corner of an unreflected tap of an in-frame cell lies in the box
placed at the slot's first lattice position plus the first tap's offset,
as the variant places it, and the extent is at most one pixel more than
the widest slot needs.
"""

import numpy as np
import pytest
import torch

from stnls_tpu_torch import b5_b6_variants
from stnls_tpu_torch.ops import cuda_lib
from stnls_tpu_torch.ops.nls_k import search_aux

# (ws, ps, stride1, dilation, use_adj, itype)
BOX_CASES = [(5, 3, 0.5, 1, False, "float"), (5, 1, 1., 1, False, "float"),
             (9, 1, 1., 1, False, "float"), (5, 5, 0.5, 2, True, "float"),
             (7, 7, 0.25, 1, False, "float"), (5, 3, 2., 1, False, "float"),
             (5, 3, 1, 1, False, "int"), (5, 3, 2, 2, True, "int")]


def _axis_span(pos, first, ps, dil, po, L, is_int):
    """pos [..., ws] lattice positions of one axis, first [...] the box's
    origin: (lowest, highest) corner pixel - origin over the unreflected
    in-frame taps of in-frame cells, per (query, slot)."""
    inb = (pos >= 0) & (pos <= L - 1)
    taps = pos[..., :, None] + dil * (torch.arange(ps) + po).float()
    use = inb[..., None] & (taps >= 0) & (taps <= L - 1)
    i0 = torch.floor(taps)
    i1 = i0 if is_int else torch.where(i0 + 1 <= L - 1, i0 + 1, i0)
    rel0 = i0 - first[..., None, None]
    rel1 = i1 - first[..., None, None]
    big = torch.tensor(1e9)
    lo = torch.where(use, rel0, big).amin((-2, -1))
    hi = torch.where(use, rel1, -big).amax((-2, -1))
    return lo, hi


@pytest.mark.parametrize("ws,ps,stride1,dil,use_adj,itype", BOX_CASES)
def test_box_extent_covers_the_corners_the_plain_volume_reads(
        ws, ps, stride1, dil, use_adj, itype):
    rng = np.random.default_rng(21)
    B, HD, T, H, W, wt = 1, 1, 3, 24, 28, 1
    flows = torch.from_numpy((3 * rng.standard_normal(
        (B, HD, T, 2, 2, H, W))).astype(np.float32))
    aux = search_aux((B, HD, T, 1, H, W), flows, ws=ws, wt=wt, stride0=1,
                     stride1=stride1, itype=itype)
    is_int = itype == "int"
    E = b5_b6_variants.box_extent(ws, ps, stride1, dil, itype)
    po = 0 if use_adj else -(ps // 2)
    widest = 0
    for name, L, base in (("dh", H, torch.arange(H)[:, None]),
                          ("dw", W, torch.arange(W)[None, :])):
        # positions [B,HD,T,W_t,nH,nW,ws]
        pos = (aux[name].float() + base.float()).movedim(4, -1)
        first = torch.floor(pos[..., 0] + dil * po)
        lo, hi = _axis_span(pos, first, ps, dil, po, L, is_int)
        seen = lo < 1e9
        assert seen.any()
        assert int(lo[seen].min()) >= 0, name
        assert int(hi[seen].max()) < E, name
        widest = max(widest, int((hi - lo)[seen].max()) + 1)
    if not is_int:
        assert widest >= E - 1


def test_box_side_is_capped_to_the_shared_memory():
    cfg = dict(ws=5, ps=3, stride1=0.5, dilation=1, itype="float")
    assert b5_b6_variants.box_extent(**cfg) == 7
    wide = dict(cfg, stride1=2.)          # 13 x 13 pixels
    assert b5_b6_variants.box_extent(**wide) == 13
    # 7 x 7 pixels x 4 channels x 128 threads: 100,352 bytes
    assert b5_b6_variants.box_side(cfg, 4) == 7
    assert b5_b6_variants.box_side(wide, 4) == 7      # capped to what fits
    assert b5_b6_variants.box_side(wide, 1) == 13
    for vw in (1, 2, 4):
        side = b5_b6_variants.box_side(wide, vw)
        assert side * side * vw * 4 * b5_b6_variants.BOX_THREADS <= \
            b5_b6_variants.BOX_SMEM


@pytest.mark.parametrize("same", [True, False])
def test_channels_last_pair(same):
    rng = np.random.default_rng(3)
    v0 = torch.from_numpy(rng.standard_normal((1, 2, 3, 5, 4, 6))
                          .astype(np.float32))
    v1 = v0 if same else torch.from_numpy(
        rng.standard_normal(v0.shape).astype(np.float32))
    Fp = cuda_lib.channel_layout(5)[3]
    c0, c1 = cuda_lib.channels_last_pair(v0, v1, Fp)
    assert (c1 is c0) == same
    assert torch.equal(cuda_lib.channels_first(c0, 5), v0)
    assert torch.equal(cuda_lib.channels_first(c1, 5), v1)
    assert c0.shape == (1, 2, 3, 4, 6, Fp) and c0.is_contiguous()


@pytest.mark.parametrize("F", [1, 2, 3, 4, 5, 8, 16, 32, 33, 128, 200])
def test_channel_layout(F):
    vw, ng, npass, Fp = cuda_lib.channel_layout(F)
    assert vw == (1 if F == 1 else 2 if F == 2 else 4)
    assert Fp == vw * ng * npass and Fp >= F and Fp - F < vw * ng
    assert 1 <= ng <= 32 and ng & (ng - 1) == 0
    x = torch.arange(2 * F * 6, dtype=torch.float32).reshape(2, F, 2, 3)
    cl = cuda_lib.channels_last(x, Fp)
    assert cl.shape == (2, 2, 3, Fp) and not cl[..., F:].any()
    assert torch.equal(cuda_lib.channels_first(cl, F), x)

