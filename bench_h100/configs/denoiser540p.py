"""The NonLocalDenoiser at 540p: its clips and weights, the port's step in
each mode, its work from shapes, its reference and its control.

Train mode drives stnls_tpu_torch.matrix_steps' "denoiser540p_train_step"
(the loss and every parameter's gradient: convs, B1, softmax, B3, the
projections, then B4, B2 and the convs' backward); infer mode drives the
same NonLocalDenoiser's forward (matrix_steps.denoiser) under
torch.inference_mode. Both take this benchmark's weights and the
configuration's widths in place of config 6's.
"""

import torch

from bench_h100 import inputs
from bench_h100 import work as yardstick
from bench_h100.reference import denoiser540p as reference


def frames(cfg):
    return cfg["B"] * cfg["T"]


def clip(gen, cfg, traffic, device):
    B, T, C, H, W = (cfg[k] for k in "BTCHW")
    clean = inputs.normal(gen, (B, T, C, H, W), device)
    noisy = clean + traffic["noise_sigma"] * inputs.normal(
        gen, (B, T, C, H, W), device)
    flows = [inputs.smooth_flows(gen, (B, T, 2, H, W), traffic["flow_amp"],
                                 traffic["flow_modes"], device)
             for _ in range(2)]
    return dict(noisy=noisy, clean=clean, fflow=flows[0], bflow=flows[1])


def parameter_shapes(cfg):
    """{name: shape} of the NonLocalDenoiser's parameters, and the fan-in
    of the layer each belongs to."""
    io, C = cfg["embed_dim"] * cfg["nheads"], cfg["C"]
    hid = max(io // 4, 1)
    layers = {"embed": ((io, C, 3, 3), C * 9)}
    for n in "qkv":
        layers[f"attn.qkv.to_{n}"] = ((io, io, 1, 1), io)
    layers["attn.proj"] = ((io, io, 1, 1), io)
    for i in range(cfg["nres"]):
        for j in (0, 1):
            layers[f"res.block{i}.conv{j}"] = ((io, io, 3, 3), io * 9)
    layers["chnl.dense0"] = ((hid, io), io)
    layers["chnl.dense1"] = ((io, hid), hid)
    layers["out"] = ((C, io, 3, 3), io * 9)
    shapes = {}
    for name, (shape, fan_in) in layers.items():
        shapes[f"{name}.weight"] = (shape, fan_in)
        shapes[f"{name}.bias"] = ((shape[0],), fan_in)
    return shapes


def state(gen, cfg, device):
    """The weights, {name: tensor} on the device, in one draw."""
    shapes = parameter_shapes(cfg)
    tensors = inputs.uniform_weights(
        gen, [s for s, _ in shapes.values()],
        [fan ** -0.5 for _, fan in shapes.values()], device)
    return dict(zip(shapes, tensors))


def _size(cfg):
    return {k: cfg[k] for k in ("B", "T", "C", "H", "W", "embed_dim",
                                "nheads", "ws", "wt", "ps", "K", "nres")}


def step(cfg, mode, params):
    from stnls_tpu_torch import matrix_steps
    from stnls_tpu_torch.utils.config import ConfigDict
    name = "denoiser540p_train_step"
    if mode == "train":
        run = matrix_steps.make_step(name, params=params, **_size(cfg))

        def one(c):
            return run(c["noisy"], c["clean"], c["fflow"], c["bflow"])
        return one
    model = matrix_steps.denoiser(name, **_size(cfg))
    model.load_state_dict(params)
    device = next(iter(params.values())).device
    model.to(device).eval()

    def infer(c):
        with torch.inference_mode():
            out, _ = model(c["noisy"], ConfigDict(fflow=c["fflow"],
                                                  bflow=c["bflow"]))
        return dict(out=out)
    return infer


def work(cfg, mode):
    """Operations and bytes of B1 and B3 (and in train mode B2 and B4),
    and the step's operations: theirs and the convs' (the forward; in
    train mode also each conv's weight gradient and, but for the
    embedding's, its input gradient)."""
    HD, train = cfg["nheads"], mode == "train"
    F = cfg["embed_dim"]
    shape = dict(B=cfg["B"], HD=HD, T=cfg["T"], F=F, H=cfg["H"],
                 W=cfg["W"])
    search = dict(ws=cfg["ws"], wt=cfg["wt"], ps=cfg["ps"], K=cfg["K"])
    agg = dict(ps=cfg["ps"], K=cfg["K"])
    out = {"B1": yardstick.b1_work(**shape, **search),
           "B3": yardstick.b3_work(**shape, **agg)}
    if train:
        out["B2"] = yardstick.b2_work(**shape, **search)
        out["B4"] = yardstick.b4_work(**shape, **agg)
    N, H, W, C = cfg["B"] * cfg["T"], cfg["H"], cfg["W"], cfg["C"]
    io = F * HD
    convs = [(C, io, 3, False)] + [(io, io, 1, True)] * 4 \
        + [(io, io, 3, True)] * (2 * cfg["nres"]) + [(io, C, 3, True)]
    flops = sum(yardstick.conv_step_flops(N, H, W, ci, co, k, train, g_in)
                for ci, co, k, g_in in convs)
    out["step"] = sum(f for _, f in out.values()) + flops
    return out


def judge(c, out, cfg, mode, params):
    return reference.judge(c, out, params, cfg, mode)


def control(c, cfg, mode, params):
    """The reference with TF32 convs and linear layers, put in the
    program's place."""
    return reference.outputs(c, params, cfg, mode, round_tf32=True)
