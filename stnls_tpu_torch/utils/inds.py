"""Query-index batching helpers (PyTorch port of stnls_tpu/utils/inds.py,
the reference's utils/inds.py:48-80)."""

import numpy as np
import torch


def get_batching_info(vshape, stride0, stride1, ps, dilation=1):
    """Numbers of queries/keys per frame and total (reference
    get_batching_info)."""
    T, _, H, W = vshape[-4:]
    nH0 = (H - 1) // stride0 + 1
    nW0 = (W - 1) // stride0 + 1
    nH1 = (H - 1) // stride1 + 1
    nW1 = (W - 1) // stride1 + 1
    return {"nH0": nH0, "nW0": nW0, "q_per_frame": nH0 * nW0,
            "ntotal_q": T * nH0 * nW0,
            "nH1": nH1, "nW1": nW1, "k_per_frame": nH1 * nW1,
            "ntotal_k": T * nH1 * nW1}


def get_query_inds(qindex, nqueries, stride0, T, H, W, device="cuda"):
    """Raster (t, h, w) locations [nqueries, 3] int32 for queries
    [qindex, qindex+nqueries)."""
    nH = (H - 1) // stride0 + 1
    nW = (W - 1) // stride0 + 1
    qi = np.arange(qindex, qindex + nqueries)
    t = qi // (nH * nW)
    rem = qi - t * nH * nW
    h = (rem // nW) * stride0
    w = (rem % nW) * stride0
    return torch.from_numpy(np.stack([t, h, w], -1).astype(np.int32)) \
        .to(device)


def get_nums_hw(vshape, stride, H=None, W=None):
    if H is None:
        H, W = vshape[-2:]
    return (H - 1) // stride + 1, (W - 1) // stride + 1
