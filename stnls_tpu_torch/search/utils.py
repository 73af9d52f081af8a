"""Shared search-layer helpers (PyTorch port of stnls_tpu/search/utils.py)."""

import torch

from stnls_tpu_torch.ops.nls import dist_type_select  # noqa: F401


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


def unshape_vid(vid):
    """[B,HD,T,F,H,W] -> [B,T,(HD F),H,W]."""
    B, HD, T, F, H, W = vid.shape
    return vid.permute(0, 2, 1, 3, 4, 5).reshape(B, T, HD * F, H, W)


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


def ensure_flow_shape(flow):
    """[B,T,2,H,W] -> [B,1,T,2,H,W]; other shapes pass."""
    if flow.ndim == 5:
        B, T, _, H, W = flow.shape
        flow = flow.reshape(B, 1, T, 2, H, W)
    return flow


def empty_flow(vid):
    """Zero flow [B,T,2,H,W] for a [B,T,C,H,W] video."""
    B, T = vid.shape[:2]
    H, W = vid.shape[-2:]
    return torch.zeros((B, T, 2, H, W), dtype=vid.dtype, device=vid.device)


def search_wrap(name, search):
    """Uniform-signature wrapper over any search flavour: every call takes
    (vid0, vid1, fflow, bflow, inds, afflow, abflow)."""
    if "refine" in name:
        def wrap(vid0, vid1, fflow, bflow, inds, afflow, abflow):
            return search(vid0, vid1, inds)
        return wrap
    if "pf" in name:
        def wrap(vid0, vid1, fflow, bflow, inds, afflow, abflow):
            return search(vid0, vid1, afflow, abflow)
        return wrap

    def wrap(vid0, vid1, fflow, bflow, inds, afflow, abflow):
        return search(vid0, vid1, fflow, bflow)
    return wrap


def filter_k(inds, kr, k=None):
    """Keep the first Ks of the K offsets [..., K, C]: kr a ratio (float
    in (0, 1]) or a count; kr None or <= 0 keeps them all."""
    K = inds.shape[-2] if k is None else k
    kr = K if kr is None else kr
    if kr <= 0:
        return inds
    if isinstance(kr, float):
        if not 0 < kr <= 1:
            raise ValueError(f"kr={kr}: a ratio must be in (0, 1]")
        Ks = int(K * kr)
    else:
        Ks = int(kr)
    return inds[..., :Ks, :]


def get_time_window_inds(ti, wt, T):
    """The boundary-shifted time window of frame ti: the 2*wt+1 frames a
    search from ti visits, in slot order."""
    t_shift = min(0, ti - wt) + max(0, ti + wt - (T - 1))
    t_max = min(T - 1, ti + wt - t_shift)
    inds = []
    for st in range(2 * wt + 1):
        tj = ti + st
        inds.append(tj if tj <= t_max else t_max - st)
    return inds


def paired_vids(forward, vid0, vid1, flows, wt, skip_self=False):
    """A space-time search as 2-frame searches: forward(frame0, frame1,
    flow) over the time window of every frame, the frame offset prepended
    to the 2-d offsets. flows [B,(HD),T,W_t-1,2,nH,nW]. Returns dists
    [B,HD,T,nH,nW,W_t*K] and inds [B,HD,T,nH,nW,W_t*K,3]."""
    dists_all, inds_all = [], []
    T = vid0.shape[1]
    if flows.ndim == 6:
        flows = flows[:, None]
    zflow = torch.zeros_like(flows[:, :, 0, 0])
    for ti in range(T):
        t_grid = get_time_window_inds(ti, wt, T)
        dists_i, inds_i = [], []
        for _tj in range(2 * wt + 1):
            tj = t_grid[_tj]
            if ti == tj and skip_self:
                continue
            flow = flows[:, :, ti, _tj - 1] if _tj > 0 else zflow
            d_ij, i_ij = forward(vid0[:, ti], vid1[:, tj], flow.float())
            i_t = (tj - ti) * torch.ones_like(i_ij[..., :1])
            dists_i.append(d_ij)
            inds_i.append(torch.cat([i_t, i_ij], dim=-1))
        dists_all.append(torch.cat(dists_i, dim=-1))
        inds_all.append(torch.cat(inds_i, dim=-2))
    return torch.stack(dists_all, dim=-4), torch.stack(inds_all, dim=-5)


def paired_vids_refine(forward, vid0, vid1, flows, wt, skip_self=False,
                       check_time=True):
    """PairedRefine over a whole video: for each (ti, tj) window slot,
    forward(frame0, frame1, flows_k) refines around that slot's share of
    the K given offsets (K divisible by the W_t slots; the offsets
    [B,(HD),T,nH,nW,K,3] keep their dt first). Returns dists and inds as
    `paired_vids`."""
    dists_all, inds_all = [], []
    T = vid0.shape[1]
    if flows.ndim == 6:
        flows = flows[:, None]
    K_total = flows.shape[-2]
    Wt = 2 * wt + 1 - (1 if skip_self else 0)
    if K_total % Wt:
        raise ValueError("K must be divisible by the window's slots")
    K_each = K_total // Wt
    for ti in range(T):
        t_grid = get_time_window_inds(ti, wt, T)
        dists_i, inds_i = [], []
        ix = 0
        for _tj in range(2 * wt + 1):
            tj = t_grid[_tj]
            if ti == tj and skip_self:
                continue
            flow = flows[:, :, ti, :, :, ix * K_each:(ix + 1) * K_each]
            d_ij, i_ij = forward(vid0[:, ti], vid1[:, tj],
                                 flow.float()[..., 1:])
            i_t = (tj - ti) * torch.ones_like(i_ij[..., :1])
            dists_i.append(d_ij)
            inds_i.append(torch.cat([i_t, i_ij], dim=-1))
            ix += 1
        dists_all.append(torch.cat(dists_i, dim=-1))
        inds_all.append(torch.cat(inds_i, dim=-2))
    return torch.stack(dists_all, dim=-4), torch.stack(inds_all, dim=-5)
