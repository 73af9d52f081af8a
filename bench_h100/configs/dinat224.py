"""DiNAT-Tiny trained on 224x224 ImageNet-sized batches: its images and
labels, its weights, the port's training step, its work from shapes, its
reference and its control.

Train mode drives stnls_tpu_torch.models.DiNAT (dinat_tiny's 30 NA and
DiNA layers, each through NonLocalSearch's volume route and
PooledPatchSum: B5 and B9, then B10 and B6 in the backward, beside the
float32 linear layers and convs): the mean cross-entropy of the logits
and the gradient of every parameter. The model is imported in `step`, so
a program without it fails there, before any step runs.
"""

import torch
import torch.nn.functional as F_

from bench_h100 import inputs
from bench_h100 import work as yardstick
from bench_h100 import work_window
from bench_h100.reference import dinat224 as reference

MODEL_KEYS = ("in_chans", "num_classes", "embed_dim", "depths",
              "num_heads", "kernel_size", "mlp_ratio", "dilations")


def frames(cfg):
    return cfg["B"]


def clip(gen, cfg, traffic, device):
    """images [B,3,H,W] of standard normal pixels, labels [B] uniform in
    [0, num_classes)."""
    B, H, W = cfg["B"], cfg["H"], cfg["W"]
    return dict(images=inputs.normal(gen, (B, cfg["in_chans"], H, W),
                                     device),
                labels=torch.randint(0, cfg["num_classes"], (B,),
                                     generator=gen, device=device))


def state(gen, cfg, device):
    """The weights, {name: tensor} on the device: the conv, linear and
    bias-table weights in one draw, LayerNorms at (1, 0)."""
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
    """The port's DiNAT at the configuration's widths, with `params`."""
    from stnls_tpu_torch.models.dinat import DiNAT
    net = DiNAT(**{k: cfg[k] for k in MODEL_KEYS})
    net.load_state_dict(params)
    return net.to(next(iter(params.values())).device)


def step(cfg, mode, params):
    if mode != "train":
        raise ValueError(f"dinat224: no {mode!r} step")
    net = model(cfg, params)
    names, leaves = zip(*net.named_parameters())

    def one(c):
        out = net(c["images"])
        loss = F_.cross_entropy(out, c["labels"])
        grads = torch.autograd.grad(loss, leaves)
        return dict(out=out.detach(), loss=loss.detach(),
                    grads=dict(zip(names, grads)))
    return one


def _levels(cfg):
    """(map side, width, heads, dilations) of each level."""
    side = cfg["H"] // 4
    for i, d in enumerate(cfg["dilations"]):
        yield side >> i, cfg["embed_dim"] * 2 ** i, cfg["num_heads"][i], d


def work(cfg, mode):
    """Operations and bytes of B5 and B9, and in train mode of B6 and B10,
    over the step's 30 attention layers (B9 and B10 on the map padded by a
    row and a column, as the model runs them), and the step's operations:
    the linear layers and convs of the forward (three times in train
    mode: the forward, the input gradient, the weight gradient), plus the
    four kernels' own."""
    B, k = cfg["B"], cfg["kernel_size"]
    train = mode == "train"
    K = k * k
    kernels = {}

    def add(key, bytes_ops):
        old = kernels.get(key, (0, 0))
        kernels[key] = (old[0] + bytes_ops[0], old[1] + bytes_ops[1])

    C0 = cfg["embed_dim"]
    dense = yardstick.conv_flops(B, cfg["H"] // 2, cfg["W"] // 2,
                                 cfg["in_chans"], C0 // 2, 3) \
        + yardstick.conv_flops(B, cfg["H"] // 4, cfg["W"] // 4, C0 // 2, C0,
                               3)
    for i, (n, C, HD, dils) in enumerate(_levels(cfg)):
        F = C // HD
        hidden = int(C * cfg["mlp_ratio"])
        tokens = B * n * n
        layer = 2 * tokens * (3 * C * C + C * C + 2 * C * hidden)
        dense += len(dils) * layer
        if i < len(cfg["dilations"]) - 1:
            dense += yardstick.conv_flops(B, n // 2, n // 2, C, 2 * C, 3)
        shape = dict(B=B, HD=HD, F=F)
        live = B * HD * n * n * K
        for _ in dils:
            add("B5", work_window.b5_work(**shape, H=n, W=n, ws=k))
            add("B9", work_window.b9_work(**shape, H=n + 1, W=n + 1, K=K,
                                          live=live))
            if train:
                add("B6", work_window.b6_work(**shape, H=n, W=n, ws=k))
                add("B10", work_window.b10_work(**shape, H=n + 1, W=n + 1,
                                                K=K, live=live))
    C = C0 * 2 ** (len(cfg["depths"]) - 1)
    dense += 2 * B * C * cfg["num_classes"]
    out = dict(kernels)
    out["step"] = (3 if train else 1) * dense \
        + sum(f for _, f in kernels.values())
    return out


def judge(c, out, cfg, mode, params):
    return reference.judge(c, out, params, cfg, mode)


def control(c, cfg, mode, params):
    """The reference with TF32 linear layers, convs and attention
    products, put in the program's place."""
    return reference.outputs(c, params, cfg, mode, round_tf32=True)
