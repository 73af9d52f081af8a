"""The host-side rules of B8 and B9 (stnls_tpu_torch/ops/agg_sp_cuda.py):
which layout of the cotangent B8 reads, its padded channels, and the
shared memory of the centre table. Plain Python: runs on the CPU."""

import pytest

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
