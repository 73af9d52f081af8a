"""Plain reference of the 1080p alignment search (benchmarks/matrix.py
configs 5 and 7): NonLocalSearch(ws, wt, ps, K, nheads, anchor, float)
of a clip against itself, its dists and offsets, and in train mode the
gradient of mean(dists^2) to the video.

`outputs` computes all of it on its own (its own selection), in blocks
of one head and one query frame. `judge` holds a run's outputs to it:
  dists_err     largest |dist - reference's| of the ranked dists;
  inds_err      largest |dist - reference's patch distance at the run's
                own offsets|: the offsets are those of the dists;
  g_vid_err     |g_vid - reference's| / |reference's| (2-norms), the
                reference's gradient taken at the run's offsets: the
                selection is checked by the two numbers above.
"""

import torch

from bench_h100.reference import nls


def _heads(vid, HD):
    """[T,C,H,W] -> HD videos [T,F,H,W] (head-major channels)."""
    T, C, H, W = vid.shape
    F = C // HD
    return [vid[:, h * F:(h + 1) * F] for h in range(HD)]


def outputs(clip, cfg, mode, dtype=torch.float32):
    """The reference's own run in `dtype`: dists [1,HD,T,H,W,K], inds
    [...,K,3] and, in train mode, g_vid [1,T,C,H,W] (float32)."""
    vid = clip["vid"][0]
    T, C, H, W = vid.shape
    geo = nls.Geometry(clip["fflow"][0], clip["bflow"][0], cfg["ws"],
                       cfg["wt"])
    HD, K, ps = cfg["nheads"], cfg["K"], cfg["ps"]
    v = vid.to(dtype).detach().requires_grad_(mode == "train")
    n = HD * T * H * W * K
    dists = torch.empty((1, HD, T, H, W, K), device=vid.device)
    inds = torch.empty((1, HD, T, H, W, K, 3), device=vid.device)
    for h, vh in enumerate(_heads(v, HD)):
        for t in range(T):
            d, offs = nls.select(vh.detach(), vh.detach(), geo, ps, K, t)
            dists[0, h, t], inds[0, h, t] = d.float(), offs
            if mode == "train":
                dt = nls.dists_at(vh, vh, offs, ps, t)
                (dt.float().pow(2).sum() / n).backward()
    out = dict(dists=dists, inds=inds)
    if mode == "train":
        out["g_vid"] = v.grad.float()[None]
    return out


def judge(clip, out, cfg, mode):
    """The numbers of a run's outputs against the reference."""
    vid = clip["vid"][0]
    T, C, H, W = vid.shape
    geo = nls.Geometry(clip["fflow"][0], clip["bflow"][0], cfg["ws"],
                       cfg["wt"])
    HD, K, ps = cfg["nheads"], cfg["K"], cfg["ps"]
    v = vid.detach().requires_grad_(mode == "train")
    n = HD * T * H * W * K
    d_err = i_err = 0.
    for h, vh in enumerate(_heads(v, HD)):
        for t in range(T):
            d_p, i_p = out["dists"][0, h, t], out["inds"][0, h, t]
            d_r, _ = nls.select(vh.detach(), vh.detach(), geo, ps, K, t)
            d_err = max(d_err, float((d_p - d_r).abs().max()))
            with torch.set_grad_enabled(mode == "train"):
                d_at = nls.dists_at(vh, vh, i_p, ps, t)
                if mode == "train":
                    (d_at.pow(2).sum() / n).backward()
            i_err = max(i_err, float((d_at.detach() - d_p).abs().max()))
    nums = dict(dists_err=d_err, inds_err=i_err)
    if mode == "train":
        g_r = v.grad
        nums["g_vid_err"] = float((out["g_vid"][0] - g_r).norm()
                                  / g_r.norm())
    return nums

