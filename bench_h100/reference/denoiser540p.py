"""Plain reference of the NonLocalDenoiser (stnls_tpu/models/denoiser.py):
a 3x3 conv embedding, NonLocalAttention (1x1 q, k, v; the anchored flow
search of top-K patches; softmax(-s d); the patch gather; the mean over
K; a 1x1 projection), the residual, `nres` ResBlocks, squeeze-excite
channel attention and a 3x3 conv out, added to the noisy input. Train
mode adds the loss mean((out - clean)^2) and the gradient of every
parameter, by name.

`outputs` computes all of it on its own, the search in blocks of one
head and query frame and the gather a slot at a time, each under
activation checkpointing so that 540p fits. With tf32=True every conv
and linear layer reads its operands rounded to TF32 (10 bits of
mantissa), as the H100's tensor cores would: the control. `judge` holds
a run's outputs to the float32 reference:
  out_err    largest |out - reference's|;
  loss_err   |loss - reference's| / reference's;
  grad_err   the worst parameter's |grad - reference's| (2-norm) over
             the larger of its reference norm and the median parameter's.
"""

import torch
import torch.nn.functional as F_
from torch.utils.checkpoint import checkpoint

from bench_h100.reference import nls


def tf32(x):
    """x with its float32 operands rounded to TF32 (the gradient passes
    straight through)."""
    bits = x.detach().contiguous().view(torch.int32)
    r = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return x + (r - x.detach())


def _conv(x, p, name, pad, round_tf32):
    w, b = p[f"{name}.weight"], p[f"{name}.bias"]
    if round_tf32:
        x, w = tf32(x), tf32(w)
    return F_.conv2d(x, w, b, padding=pad)


def _linear(x, p, name, round_tf32):
    w, b = p[f"{name}.weight"], p[f"{name}.bias"]
    if round_tf32:
        x, w = tf32(x), tf32(w)
    return F_.linear(x, w, b)


def _attention(x, clip, p, cfg, round_tf32):
    """NonLocalAttention on x [B,T,C,H,W] -> [B,T,C,H,W]."""
    B, T, C, H, W = x.shape
    HD, K, ps = cfg["nheads"], cfg["K"], cfg["ps"]
    F = C // HD
    x4 = x.reshape(B * T, C, H, W)
    q, k, v = (_conv(x4, p, f"attn.qkv.to_{n}", 0, round_tf32)
               .reshape(B, T, HD, F, H, W) for n in "qkv")
    geo = nls.Geometry(clip["fflow"][0], clip["bflow"][0], cfg["ws"],
                       cfg["wt"])
    counts = nls.overlap_counts(H, W, ps, x.device)
    heads = []
    for h in range(HD):
        qh, kh, vh = q[0, :, h], k[0, :, h], v[0, :, h]    # [T,F,H,W]
        ws_, offs = [], []
        for t in range(T):
            _, o = nls.select(qh.detach(), kh.detach(), geo, ps, K, t)
            d = checkpoint(lambda a, b, o=o, t=t: nls.dists_at(a, b, o, ps, t),
                           qh, kh, use_reentrant=False)
            ws_.append(torch.softmax(-cfg["normz_scale"] * d, dim=-1))
            offs.append(o)
        wts, offs = torch.stack(ws_), torch.stack(offs)    # [T,H,W,K(,3)]
        acc = 0.
        for s in range(K):
            acc = acc + checkpoint(
                lambda a, b, o=offs[..., s, :]: nls.gather_slot(a, b, o, ps),
                vh, wts[..., s], use_reentrant=False) / (counts + 1e-10)
        heads.append(acc / K)
    y = torch.stack(heads, 1).reshape(B * T, C, H, W)
    return _conv(y, p, "attn.proj", 0, round_tf32).reshape(B, T, C, H, W)


def forward(clip, p, cfg, round_tf32=False):
    """The denoised clip [B,T,C,H,W] from clip["noisy"]."""
    noisy = clip["noisy"]
    B, T, C, H, W = noisy.shape
    x = _conv(noisy.reshape(B * T, C, H, W), p, "embed", 1, round_tf32)
    x = x.reshape(B, T, -1, H, W)
    y = x + _attention(x, clip, p, cfg, round_tf32)
    y = y.reshape(B * T, -1, H, W)
    for i in range(cfg["nres"]):
        blk = f"res.block{i}"
        y = y + _conv(F_.relu(_conv(y, p, f"{blk}.conv0", 1, round_tf32)),
                      p, f"{blk}.conv1", 1, round_tf32)
    gate = torch.sigmoid(_linear(F_.relu(_linear(
        y.mean(dim=(-2, -1)), p, "chnl.dense0", round_tf32)), p,
        "chnl.dense1", round_tf32))
    y = y * gate[..., None, None]
    return noisy + _conv(y, p, "out", 1, round_tf32).reshape(B, T, C, H, W)


def outputs(clip, params, cfg, mode, round_tf32=False):
    """The reference's own run: "out", and in train mode "loss" and
    "grads" (by parameter name)."""
    p = {n: t.detach().clone().requires_grad_(mode == "train")
         for n, t in params.items()}
    with torch.set_grad_enabled(mode == "train"):
        out = forward(clip, p, cfg, round_tf32)
        if mode != "train":
            return dict(out=out.detach())
        loss = (out - clip["clean"]).pow(2).mean()
        names = list(p)
        grads = torch.autograd.grad(loss, [p[n] for n in names])
    return dict(out=out.detach(), loss=loss.detach(),
                grads=dict(zip(names, grads)))


def judge(clip, out, params, cfg, mode):
    """The numbers of a run's outputs against the float32 reference."""
    ref = outputs(clip, params, cfg, mode)
    nums = dict(out_err=float((out["out"] - ref["out"]).abs().max()))
    if mode == "train":
        nums["loss_err"] = float((out["loss"] - ref["loss"]).abs()
                                 / ref["loss"].abs())
        norms = {n: float(g.norm()) for n, g in ref["grads"].items()}
        median = sorted(norms.values())[len(norms) // 2]
        nums["grad_err"] = max(
            float((out["grads"][n] - g).norm()) / max(norms[n], median)
            for n, g in ref["grads"].items())
    return nums
