"""Video Non-Local Bayes denoising (PyTorch port of
stnls_tpu/misc/vnlb.py).

Pipeline per step (classic VNLB, Arias & Morel):
  1. non-local search for K similar patches per query (flow-guided;
     NonLocalSearch with int offsets, on CUDA tensors the kernel B1),
  2. group the patches, estimate a per-group Gaussian prior (mean and
     empirical covariance in YUV),
  3. Bayes shrinkage of the group (linear MMSE given noise sigma, through
     torch.linalg.eigh; the result does not depend on the eigenvectors'
     signs),
  4. fold the filtered patches back to the video (a count-normalised
     scatter-add, accumulating index_put_).
"""

import torch

from stnls_tpu_torch.utils import config
from stnls_tpu_torch.utils.color import rgb2yuv, yuv2rgb
from stnls_tpu_torch.search.non_local_search import NonLocalSearch
from stnls_tpu_torch.ops.geometry import reflect_bounds, in_bounds, \
    num_queries


def extract_config(cfg, restrict=True):
    pairs = {"sigma": 30., "ws": 7, "wt": 1, "ps": 5, "k": 10,
             "stride0": 2, "nsteps": 2}
    return config.extract_pairs(cfg, pairs, restrict=restrict)


def _centres(inds, vshape, stride0):
    """The searched positions (t, h, w), each [B,T,nH,nW,K], of the int
    offsets inds [B,HD,T,nH,nW,K,3] (head 0), and the patch-tap offsets."""
    B, T, C, H, W = vshape
    nH, nW = num_queries(H, W, stride0)
    dev = inds.device
    ii = torch.round(inds[:, 0]).long()             # [B,T,nH,nW,K,3]
    t = torch.arange(T, device=dev)[None, :, None, None, None]
    h = (torch.arange(nH, device=dev) * stride0)[None, None, :, None, None]
    w = (torch.arange(nW, device=dev) * stride0)[None, None, None, :, None]
    return t + ii[..., 0], h + ii[..., 1], w + ii[..., 2]


def _gather_groups(vid, inds, ps, stride0):
    """Patch groups [B,T,nH,nW,K,ps*ps*C] at the searched offsets (int
    path, reflect-padded), their entries in (tap row, tap column,
    channel) order."""
    B, T, C, H, W = vid.shape
    nt, nh, nw = _centres(inds, vid.shape, stride0)
    nt, nh, nw = reflect_bounds(nt, T), reflect_bounds(nh, H), \
        reflect_bounds(nw, W)
    taps = torch.arange(ps, device=vid.device) - ps // 2
    ph = reflect_bounds(nh[..., None] + taps, H)[..., :, None, None]
    pw = reflect_bounds(nw[..., None] + taps, W)[..., None, :, None]
    c = torch.arange(C, device=vid.device)
    # vid laid out [B,T,C,H,W], flattened over (T,C,H,W)
    idx = ((nt[..., None, None, None] * C + c) * H + ph) * W + pw
    pats = torch.gather(vid.reshape(B, -1), 1, idx.reshape(B, -1))
    return pats.reshape(idx.shape[:5] + (ps * ps * C,))


def _bayes_filter(groups, sigma):
    """Linear-MMSE shrinkage per group (groups [..., K, D])."""
    mean = groups.mean(dim=-2, keepdim=True)
    cent = groups - mean
    K = groups.shape[-2]
    cov = torch.einsum("...kd,...ke->...de", cent, cent) / max(K - 1, 1)
    s2 = (sigma / 255.) ** 2
    # eigen shrinkage: signal variance max(e - s2, 0), Wiener coefficient
    # lam / (lam + s2) per eigendirection (classic VNLB Bayes filter)
    evals, evecs = torch.linalg.eigh(cov)
    lam = (evals - s2).clamp(min=0.)
    coeff = lam / (lam + s2 + 1e-10)                # [..., D]
    proj = torch.einsum("...kd,...de->...ke", cent, evecs)
    proj = proj * coeff[..., None, :]
    return mean + torch.einsum("...ke,...de->...kd", proj, evecs)


def _fold_groups(filtered, inds, vshape, ps, stride0):
    """Count-normalised fold of all K filtered patches back to their
    non-local locations; taps beyond the frame are dropped."""
    B, T, C, H, W = vshape
    nt, nh, nw = _centres(inds, vshape, stride0)
    nt = reflect_bounds(nt, T)
    nh, nw = reflect_bounds(nh, H), reflect_bounds(nw, W)
    taps = torch.arange(ps, device=filtered.device) - ps // 2
    ph = (nh[..., None] + taps)[..., :, None]
    pw = (nw[..., None] + taps)[..., None, :]
    ok = in_bounds(ph, H) & in_bounds(pw, W)        # [B,T,nH,nW,K,ps,ps]
    THW = T * H * W
    idx = (nt[..., None, None] * H + ph.clamp(0, H - 1)) * W \
        + pw.clamp(0, W - 1)
    idx = torch.where(ok, idx, torch.full_like(idx, THW))
    idx = (idx + (THW + 1) * torch.arange(B, device=idx.device)
           .view(B, 1, 1, 1, 1, 1, 1)).reshape(-1)
    pats = filtered.reshape(-1, C)                  # (.., K, ps, ps), C
    # accumulating index_put_: on CUDA it sums each destination's terms in
    # one order (sorted), so two calls agree bitwise, where index_add_'s
    # atomics would not
    out = filtered.new_zeros(B * (THW + 1), C).index_put_(
        (idx,), pats, accumulate=True)
    cnt = filtered.new_zeros(B * (THW + 1)).index_put_(
        (idx,), filtered.new_ones(idx.shape), accumulate=True)
    out = out.view(B, THW + 1, C)[:, :-1].reshape(B, T, H, W, C)
    cnt = cnt.view(B, THW + 1)[:, :-1].reshape(B, T, H, W, 1)
    return (out / (cnt + 1e-10)).permute(0, 1, 4, 2, 3)


def run_vnlb(cfg, vid, flows=None):
    """vid [B,T,C,H,W] in [0,1] (+ optional fflow/bflow dict) ->
    denoised."""
    cfg = extract_config(cfg, restrict=False)
    vid_yuv = rgb2yuv(vid) if vid.shape[2] == 3 else vid
    search = NonLocalSearch(cfg.ws, cfg.wt, cfg.ps, cfg.k,
                            stride0=cfg.stride0, dist_type="l2",
                            self_action="anchor", itype="int")
    basic = vid_yuv
    for _ in range(cfg.nsteps):
        if flows is not None:
            dists, inds = search(basic, basic, flows.fflow, flows.bflow)
        else:
            dists, inds = search(basic, basic)
        groups = _gather_groups(basic, inds, cfg.ps, cfg.stride0)
        filtered = _bayes_filter(groups, cfg.sigma)
        basic = _fold_groups(filtered, inds, vid_yuv.shape, cfg.ps,
                             cfg.stride0)
    return yuv2rgb(basic) if vid.shape[2] == 3 else basic
