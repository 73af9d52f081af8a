"""The 1080p alignment search: its clips, the port's step in each mode,
its work from shapes, its reference and its control.

Train mode drives stnls_tpu_torch.matrix_steps' "align1080p_fwd+bwd"
(the search, its dists and offsets, and the gradient of mean(dists^2) to
the video: B1, the lazy route's geometry, B2); infer mode drives
"align1080p_fwd" (the search forward). The sizes are this file's
configuration, passed to the step whole.
"""

import torch

from bench_h100 import inputs
from bench_h100 import work as yardstick
from bench_h100.reference import align1080p as reference


def frames(cfg):
    return cfg["B"] * cfg["T"]


def clip(gen, cfg, traffic, device):
    B, T, F, H, W = (cfg[k] for k in "BTFHW")
    vid = inputs.normal(gen, (B, T, F, H, W), device)
    flows = [inputs.smooth_flows(gen, (B, T, 2, H, W), traffic["flow_amp"],
                                 traffic["flow_modes"], device)
             for _ in range(2)]
    return dict(vid=vid, fflow=flows[0], bflow=flows[1])


def state(gen, cfg, device):
    return None


def step(cfg, mode, state):
    from stnls_tpu_torch import matrix_steps
    size = {k: cfg[k] for k in ("B", "T", "F", "H", "W", "ws", "wt", "ps",
                                "K")}
    run = matrix_steps.make_step(cfg["steps"][mode], HD=cfg["nheads"],
                                 itype=cfg["itype"], **size)

    def one(c):
        return run(c["vid"], c["fflow"], c["bflow"])
    return one


def work(cfg, mode):
    """Operations and bytes of the search (B1) and, in train mode, its
    backward (B2); the step's operations are theirs."""
    HD = cfg["nheads"]
    shape = dict(B=cfg["B"], HD=HD, T=cfg["T"], F=cfg["F"] // HD,
                 H=cfg["H"], W=cfg["W"])
    kw = dict(ws=cfg["ws"], wt=cfg["wt"], ps=cfg["ps"], K=cfg["K"])
    out = {"B1": yardstick.b1_work(**shape, **kw)}
    if mode == "train":
        out["B2"] = yardstick.b2_work(**shape, **kw)
    out["step"] = sum(flops for _, flops in out.values())
    return out


def judge(c, out, cfg, mode, state):
    return reference.judge(c, out, cfg, mode)


def control(c, cfg, mode, state):
    """The reference in bfloat16, put in the program's place."""
    return reference.outputs(c, cfg, mode, dtype=torch.bfloat16)
