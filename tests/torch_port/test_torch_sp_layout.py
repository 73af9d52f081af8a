"""The host-side rules of B7-B10 (stnls_tpu_torch/ops/agg_sp_cuda.py):
which layout of the cotangent B8 reads, its padded channels, and the
shared memory of the centre table; the lanes and channels-last
accumulators of B7 and B10. Plain Python: runs on the CPU."""

import pytest
import torch

from stnls_tpu_torch.ops import agg_sp_cuda, cuda_lib


@pytest.mark.parametrize("F,Fp", [(1, 1), (2, 2), (3, 4), (4, 4), (5, 8),
                                  (8, 8), (9, 16), (16, 16), (33, 40)])
def test_grouped_channels_fill_whole_channel_groups(F, Fp):
    assert cuda_lib.grouped_channels(F) == Fp
    # B3's group (agg_common.cuh::channel_group) and B8's loads of up to
    # 4 channels divide Fp
    group = 8 if Fp >= 8 else 4 if Fp > 2 else Fp
    assert Fp % group == 0 and Fp % min(group, 4) == 0 and Fp >= F


@pytest.mark.parametrize("F", [1, 3, 8, 33])
def test_scatter_layout_takes_the_copy_from_its_threshold(F):
    threshold = agg_sp_cuda.SCATTER_CHANNELS_LAST_MIN
    assert agg_sp_cuda.scatter_layout(threshold - 1, F) == (False, F)
    assert agg_sp_cuda.scatter_layout(threshold, F) == \
        (True, cuda_lib.grouped_channels(F))
    assert agg_sp_cuda.scatter_layout(8 * threshold, F)[0]


def test_table_fits_a_block_without_opt_in():
    # B9's table of one slot takes (128 / ps + 2) int4 entries; TABLE_BYTES
    # stays within the 48 KB a block may use without an opt-in
    assert 2080 <= agg_sp_cuda.TABLE_BYTES <= 48 << 10


@pytest.mark.parametrize("F", [1, 2, 3, 4, 5, 8, 16, 33, 130])
def test_channel_layout_gives_a_query_whole_lanes_of_a_block(F):
    # B7 and B10: ng lanes a query (a power of two that divides their
    # 128-thread blocks), vw channels a lane a pass, np passes, over Fp >=
    # F channels-last channels; no pass is padding alone
    vw, ng, npass, Fp = cuda_lib.channel_layout(F)
    assert vw in (1, 2, 4) and 1 <= ng <= 32 and ng & (ng - 1) == 0
    assert 128 % ng == 0
    assert Fp == vw * ng * npass >= F > (npass - 1) * ng * vw


@pytest.mark.parametrize("F", [1, 3, 8, 33])
def test_channels_last_accumulator_round_trip_drops_the_padding(F):
    # B7's output and B10's video gradient come back from channels-last
    # accumulators of Fp channels; B10 reads a channels-last video copy
    x = torch.randn(1, 2, 3, F, 5, 7)
    Fp = cuda_lib.channel_layout(F)[3]
    cl = cuda_lib.channels_last(x, Fp)
    assert tuple(cl.shape) == (1, 2, 3, 5, 7, Fp) and not cl[..., F:].any()
    back = cuda_lib.channels_first(cl, F)
    assert back.is_contiguous() and torch.equal(back, x)
