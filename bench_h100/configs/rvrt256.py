"""RVRT with Shifted-NLS alignment on 16-frame 256x256 clips: its clips
and weights, the port's training step, its work from shapes, its
reference and its control.

Train mode drives stnls_tpu_torch.models.RVRT (the Swin layers and
grouped convs of RVRT's task 006, and 28 alignments through PairedSearch
and NonLocalGather: B1, G1, B3, then B4 and B2 in the backward): the loss
mean((out - clean)^2) and the gradient of every parameter. The step also
returns each alignment's selected dists and offsets, detached, so that
the reference is judged at the run's own selection.
"""

import math

import torch

from bench_h100 import inputs
from bench_h100 import work as yardstick
from bench_h100.reference import rvrt256 as reference

MODEL_KEYS = ("in_chans", "embed_dim", "num_heads", "window_size",
              "num_blocks", "depth", "mlp_ratio", "inputconv_groups",
              "attention_heads", "ws")


def frames(cfg):
    return cfg["B"] * cfg["T"]


def clip(gen, cfg, traffic, device):
    """lq [B,T,4,H,W] (noisy RGB and the sigma map), clean [B,T,3,H,W],
    fflow and bflow [B,T-1,2,H/4,W/4]."""
    B, T, H, W = (cfg[k] for k in "BTHW")
    clean = inputs.normal(gen, (B, T, 3, H, W), device)
    sigma = torch.rand((B, 1, 1, 1, 1), generator=gen, device=device) \
        * traffic["sigma_max"]
    noisy = clean + sigma * inputs.normal(gen, (B, T, 3, H, W), device)
    lq = torch.cat([noisy, sigma.expand(B, T, 1, H, W)], 2)
    flows = [inputs.smooth_flows(gen, (B, T - 1, 2, H // 4, W // 4),
                                 traffic["flow_amp"], traffic["flow_modes"],
                                 device) for _ in range(2)]
    return dict(lq=lq, clean=clean, fflow=flows[0], bflow=flows[1])


def state(gen, cfg, device):
    """The weights, {name: tensor} on the device: the conv, linear and
    relative-position weights in one draw, LayerNorms at (1, 0)."""
    shapes = reference.parameter_shapes(cfg)
    drawn = [n for n, (_, init) in shapes.items()
             if init[0] in ("fan", "table")]
    bounds = [shapes[n][1][1] ** -0.5 if shapes[n][1][0] == "fan" else 0.02
              for n in drawn]
    params = dict(zip(drawn, inputs.uniform_weights(
        gen, [shapes[n][0] for n in drawn], bounds, device)))
    fill = {"one": 1., "zero": 0.}
    return {n: params[n] if n in params else
            torch.full(shape, fill[init[0]], device=device)
            for n, (shape, init) in shapes.items()}


def model(cfg, params):
    """The port's RVRT at the configuration's widths, with `params`."""
    from stnls_tpu_torch.models.rvrt import RVRT
    net = RVRT(k=cfg["K"], **{k: cfg[k] for k in MODEL_KEYS})
    net.load_state_dict(params)
    return net.to(next(iter(params.values())).device)


def step(cfg, mode, params):
    if mode != "train":
        raise ValueError(f"rvrt256: no {mode!r} step")
    net = model(cfg, params)
    names, leaves = zip(*net.named_parameters())

    def one(c):
        selections = []
        out = net(c["lq"], c["fflow"], c["bflow"], selections)
        # on a contiguous copy, as the reference takes it: the same
        # reduction in the same order on both sides
        loss = (out.contiguous() - c["clean"]).pow(2).mean()
        grads = torch.autograd.grad(loss, leaves)
        return dict(out=out.detach(), loss=loss.detach(),
                    grads=dict(zip(names, grads)), align=selections)
    return one


def _swin_flops(tokens, pad_tokens, C, hidden, N):
    """One Swin layer's forward: the qkv and projection layers and the two
    attention matmuls over the `pad_tokens` tokens of whole windows of N,
    the MLP over the `tokens` unpadded ones."""
    return 2 * pad_tokens * (3 * C * C + C * C) + 4 * pad_tokens * N * C \
        + 2 * tokens * (2 * C * hidden + hidden * C)


def _rstb_conv_flops(tokens, c_in, groups, blocks, cfg, window, extent):
    """RSTBWithInputConv's forward over `tokens` pixels of an input of
    extent (D, h, w)."""
    C, depth = cfg["embed_dim"], cfg["depth"]
    win = [min(n, w) for n, w in zip(extent, window)]
    padded = math.prod(-(-n // w) * w for n, w in zip(extent, win))
    pad_tokens = tokens * padded // math.prod(extent)
    swin = _swin_flops(tokens, pad_tokens, C, int(C * cfg["mlp_ratio"]),
                       math.prod(win))
    return yardstick.conv_flops(tokens, 1, 1, c_in // groups, C, 3) \
        + blocks * (depth * swin + 2 * tokens * C * C)


def work(cfg, mode):
    """Operations and bytes of B1 and B3 (and in train mode B2 and B4) over
    the step's alignments, and the step's operations: the linear layers,
    the attention matmuls and the convs of the forward (three times in
    train mode: the forward, the input gradient, the weight gradient),
    plus the four kernels' own."""
    B, T, H, W = (cfg[k] for k in "BTHW")
    C, g = cfg["embed_dim"], cfg["inputconv_groups"]
    h, w = H // 4, W // 4
    win = tuple(cfg["window_size"])
    frame_win = (1,) + win[1:]
    train = mode == "train"
    n_align = 4 * (T // 2 - 1)
    HD = cfg["attention_heads"]
    shape = dict(B=4 * B, HD=HD, T=1, F=2 * C // HD, H=h, W=w)
    search = dict(ws=cfg["ws"], wt=0, ps=1, K=cfg["K"])
    kernels = {"B1": yardstick.b1_work(**shape, **search),
               "B3": yardstick.b3_work(**shape, ps=1, K=cfg["K"])}
    if train:
        kernels["B2"] = yardstick.b2_work(**shape, **search)
        kernels["B4"] = yardstick.b4_work(**shape, ps=1, K=cfg["K"])
    out = {k: (n_align * b, n_align * f) for k, (b, f) in kernels.items()}

    frame_px, clip_px = B * T * h * w, B * 2 * h * w
    dense = yardstick.conv_flops(B * T, H // 2, W // 2, cfg["in_chans"], C,
                                 3) + yardstick.conv_flops(B * T, h, w, C, C,
                                                           3)
    dense += _rstb_conv_flops(frame_px, C, g[0], cfg["num_blocks"][0], cfg,
                              frame_win, (T, h, w))
    for i in range(4):
        dense += T // 2 * _rstb_conv_flops(
            clip_px, (2 + i) * C, g[i + 1], cfg["num_blocks"][1], cfg, win,
            (2, h, w))
    dense += n_align * 2 * clip_px * (3 * C * 2 * C + 2 * C * C
                                      + 2 * (C * 2 * C))
    dense += _rstb_conv_flops(frame_px, 5 * C, g[5], cfg["num_blocks"][2],
                              cfg, frame_win, (T, h, w))
    dense += yardstick.conv_flops(B * T, h, w, C, 64, 1) \
        + yardstick.conv_flops(B * T, h, w, 64, 256, 3) \
        + yardstick.conv_flops(B * T, 2 * h, 2 * w, 64, 256, 3) \
        + yardstick.conv_flops(B * T, H, W, 64, 64, 3) \
        + yardstick.conv_flops(B * T, H, W, 64, 3, 3)
    out["step"] = (3 if train else 1) * dense \
        + sum(f for _, f in out.values())
    return out


def judge(c, out, cfg, mode, params):
    return reference.judge(c, out, params, cfg, mode)


def control(c, cfg, mode, params):
    """The reference with TF32 linear layers, convs and attention matmuls,
    its own selection, put in the program's place."""
    return reference.outputs(c, params, cfg, mode, round_tf32=True)
