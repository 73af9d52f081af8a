"""Shared search-layer helpers (PyTorch port of stnls_tpu/search/utils.py)."""

import torch


def shape_vids(nheads, vids):
    """[B,T,(HD F),H,W] -> [B,HD,T,F,H,W]."""
    out = []
    for vid in vids:
        if vid.ndim not in (5, 6):
            raise ValueError("vid must be 5 or 6 dims")
        if vid.ndim == 5:
            B, T, C, H, W = vid.shape
            if C % nheads:
                raise ValueError("channels must divide nheads")
            vid = vid.reshape(B, T, nheads, C // nheads, H, W)
            vid = vid.permute(0, 2, 1, 3, 4, 5)
        if not (vid.shape[1] == nheads or nheads == 1):
            raise ValueError("vid heads must match nheads")
        out.append(vid)
    return out


def shape_flows(nheads, flows):
    """Add the head dim if missing: [B,T,W_t,2,nH,nW] -> [B,1,T,W_t,2,nH,nW]."""
    if flows.ndim == 7:
        return flows
    if flows.ndim == 6:
        return flows[:, None]
    raise ValueError(f"flows must be 6 or 7 dims, got {flows.ndim}")


def empty_flows(vid, wt, stride0, nheads=1):
    """All-zero flow volume for the 2-arg search call."""
    B = vid.shape[0]
    H, W = vid.shape[-2:]
    T = vid.shape[2] if vid.ndim == 6 else vid.shape[1]
    W_t = min(2 * wt + 1, T)
    nH = (H - 1) // stride0 + 1
    nW = (W - 1) // stride0 + 1
    return torch.zeros((B, nheads, T, W_t - 1, 2, nH, nW),
                       dtype=torch.float32, device=vid.device)
