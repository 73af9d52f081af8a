"""Shared agg-layer shaping helpers (PyTorch port of stnls_tpu/agg/utils.py)."""


def ensure_ndim6(vid, nheads):
    if vid.ndim == 5:
        B, T, C, H, W = vid.shape
        if C % nheads == 0:
            vid = vid.reshape(B, T, nheads, C // nheads, H, W)
            vid = vid.permute(0, 2, 1, 3, 4, 5)
        else:
            vid = vid[:, None]
    if vid.ndim != 6:
        raise ValueError("vid must be [B,T,C,H,W] or [B,HD,T,F,H,W]")
    return vid


def ensure_flow_heads(flows):
    if flows.ndim == 4:  # [B,Q,K,3]
        flows = flows[:, None]
    return flows


def expand_heads(arr, HD):
    """Broadcast a 1-head tensor over HD heads."""
    if arr.shape[1] == HD:
        return arr
    if arr.shape[1] != 1:
        raise ValueError(f"cannot broadcast {arr.shape[1]} heads to {HD}")
    return arr.expand((arr.shape[0], HD) + tuple(arr.shape[2:]))
