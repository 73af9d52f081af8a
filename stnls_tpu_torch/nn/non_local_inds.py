"""Absolute search-grid coordinates (PyTorch port of
stnls_tpu/nn/non_local_inds.py): the flow-shifted window positions as
float (t, h, w), no distances. Feeds N3MatMultSearch."""

from stnls_tpu_torch.ops import flow_ops


def non_local_inds(fflow, bflow, ws, wt, stride0, stride1):
    """Returns inds [B,T,nH,nW,W_t*ws*ws,3] of absolute float coords."""
    grid = flow_ops.non_local_inds(fflow, bflow, ws, wt, stride0, stride1)
    # [3,B,T,W_t,ws,ws,nH,nW] -> [B,T,nH,nW,W_t*ws*ws,3]
    _, B, T, W_t, ws_, _, nH, nW = grid.shape
    return grid.permute(1, 2, 6, 7, 3, 4, 5, 0).reshape(
        B, T, nH, nW, W_t * ws_ * ws_, 3)
