"""The configurations of benchmarks/matrix.py that the port runs, in
PyTorch.

  config 1, davis64_int: DAVIS 64^2, int offsets: search -> softmax(-10 d)
      -> NonLocalGather -> mean(out^2), forward and backward into the video;
  config 4, gda540p_ws9: a 9x9 window without flows on 540p frames,
      mean(d^2), forward and backward into the video;
  configs 5 and 7, align1080p_fwd and align1080p_fwd+bwd: the 1080p
      alignment search over T = 10 frames (F = 4, two heads of 2), its
      dists forward, and mean(d^2) forward and backward into the video;
  config 6, denoiser540p_train_step: the NonLocalDenoiser (embed_dim 8,
      two heads, ws 5, wt 1, ps 3, K 8, one res block) on 540p RGB frames,
      the loss mean((denoiser(noisy) - vid)^2) and its gradients to every
      parameter.

`CONFIGS` holds each at its published size. `make_inputs` draws its
inputs from a numpy seed in matrix.py's order (config 1 takes matrix.py's
random fallback: its `load_burst_batch()` call without arguments always
fails into it). `make_step` builds the search (and config 1's gather, or
config 6's denoiser) through the port's public modules and returns the
step. There is no timing loop and no output file: a benchmark wraps these.
On CUDA tensors a step runs the search kernel B1 with its backward B2 (and
the gather B3/B4 for configs 1 and 6); on CPU tensors their plain
versions.

matrix.py's TPU-only knobs (flow_budget, spread_budget, band_dtype,
wt_hint, agg_budget, agg_spread) are passed as it passes them and do
nothing: band_dtype="float16" casts the TPU's banded outputs to fit a
16 GB chip, and the port keeps float32.
"""

import numpy as np
import torch

from stnls_tpu_torch.agg.gather import NonLocalGather
from stnls_tpu_torch.attn_step import smooth_flows
from stnls_tpu_torch.models.denoiser import NonLocalDenoiser
from stnls_tpu_torch.search.non_local_search import NonLocalSearch
from stnls_tpu_torch.utils.config import ConfigDict

CONFIGS = {
    "davis64_int": dict(config=1, B=1, T=3, F=16, H=64, W=64, ws=5, wt=1,
                        ps=1, K=4, HD=1, itype="int", backward=True),
    "gda540p_ws9": dict(config=4, B=1, T=3, F=16, H=540, W=960, ws=9, wt=0,
                        ps=1, K=9, HD=1, itype="float", backward=True),
    "align1080p_fwd": dict(config=5, B=1, T=10, F=4, H=1080, W=1920, ws=5,
                           wt=3, ps=1, K=10, HD=2, itype="float",
                           backward=False),
    "align1080p_fwd+bwd": dict(config=7, B=1, T=10, F=4, H=1080, W=1920,
                               ws=5, wt=3, ps=1, K=10, HD=2, itype="float",
                               backward=True),
    "denoiser540p_train_step": dict(config=6, B=1, T=3, C=3, H=540, W=960,
                                    embed_dim=8, nheads=2, ws=5, wt=1, ps=3,
                                    K=8, nres=1, backward=True),
}
# the budgets matrix.py gives the 1080p search and the denoiser's search
# and gather (TPU-only; no effect here)
_ALIGN_KNOBS = dict(flow_budget=16, spread_budget=(12, 16),
                    band_dtype="float16")
DENOISER_SEARCH = {"flow_budget": 8, "spread_budget": (12, 14),
                   "band_dtype": "float16"}
DENOISER_AGG = {"agg_budget": 12, "agg_spread": (16, 20), "wt_hint": 2}


def config(name, **size):
    """CONFIGS[name] with entries (e.g. T, H, W) replaced."""
    return dict(CONFIGS[name], **size)


def make_inputs(name, seed=0, device="cuda", **size):
    """The config's inputs from numpy seed `seed`, in matrix.py's order:
    (vid,) for config 4, (vid, flows, flows) for config 1 (rounded flows,
    used as both fflow and bflow), (vid, fflow, bflow) for configs 5 and 7
    (flows of amplitude 3), (noisy, vid, fflow, bflow) for config 6 (noisy
    = vid + 0.1 * noise, drawn after vid); vid [B,T,F,H,W] (config 6:
    [B,T,C,H,W]), flows [B,T,2,H,W]."""
    cfg = config(name, **size)
    if cfg["config"] == 6:
        B, T, C, H, W = (cfg[k] for k in "BTCHW")
        rng = np.random.default_rng(seed)
        vid = torch.from_numpy(rng.standard_normal((B, T, C, H, W))
                               .astype(np.float32))
        noise = torch.from_numpy(rng.standard_normal((B, T, C, H, W))
                                 .astype(np.float32))
        arrays = (vid + 0.1 * noise, vid,
                  torch.from_numpy(smooth_flows(rng, (B, T, 2, H, W),
                                                amp=3.0)),
                  torch.from_numpy(smooth_flows(rng, (B, T, 2, H, W),
                                                amp=3.0)))
        return tuple(x.to(device) for x in arrays)
    B, T, F, H, W = (cfg[k] for k in "BTFHW")
    rng = np.random.default_rng(seed)
    vid = rng.standard_normal((B, T, F, H, W)).astype(np.float32)
    if cfg["config"] == 1:
        flows = np.round(smooth_flows(rng, (B, T, 2, H, W)))
        arrays = (vid, flows, flows)
    elif cfg["config"] == 4:
        arrays = (vid,)
    else:
        arrays = (vid, smooth_flows(rng, (B, T, 2, H, W), amp=3.0),
                  smooth_flows(rng, (B, T, 2, H, W), amp=3.0))
    return tuple(torch.from_numpy(x).to(device) for x in arrays)


def seeded_parameters(module, seed):
    """Draw the weights and biases of every Conv2d, Conv3d and Linear of
    `module` from a torch.Generator seeded `seed`, uniform within
    +-1/sqrt(fan-in) (torch's default bound), in the order of
    module.modules(). Returns the module."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in module.modules():
            if not isinstance(mod, (torch.nn.Conv2d, torch.nn.Conv3d,
                                    torch.nn.Linear)):
                continue
            bound = 1. / np.sqrt(mod.weight[0].numel())
            for p in (mod.weight, mod.bias):
                if p is not None:
                    p.copy_(torch.empty(p.shape).uniform_(-bound, bound,
                                                          generator=gen))
    return module


def denoiser(name="denoiser540p_train_step", **size):
    """Config 6's NonLocalDenoiser (on the CPU, torch's default
    initialisation), with matrix.py's search and agg overrides."""
    cfg = config(name, **size)
    return NonLocalDenoiser(
        in_dim=cfg["C"], embed_dim=cfg["embed_dim"], nheads=cfg["nheads"],
        ws=cfg["ws"], wt=cfg["wt"], ps=cfg["ps"], k=cfg["K"],
        nres=cfg["nres"], search_overrides=DENOISER_SEARCH,
        agg_overrides=DENOISER_AGG)


def _denoiser_step(model):
    def step(noisy, vid, fflow, bflow):
        if next(model.parameters()).device != noisy.device:
            model.to(noisy.device)
        out, _ = model(noisy, ConfigDict(fflow=fflow, bflow=bflow))
        loss = (out - vid).pow(2).mean()
        names, params = zip(*model.named_parameters())
        grads = torch.autograd.grad(loss, params)
        return dict(out=out.detach(), loss=loss.detach(),
                    grads=dict(zip(names, grads)))

    step.model = model
    return step


def make_step(name, params=None, seed=0, **size):
    """The config's step: step(*make_inputs(...)) -> dict of "dists" and
    "inds" (the search's), and, for a step with a backward, "loss" and
    "g_vid" (its gradient to the video). Config 6's step returns "out"
    (the denoised video), "loss" and "grads" (a dict of every parameter's
    gradient, by name); its denoiser, `step.model`, takes `params` (a
    state_dict, e.g. from convert.params_from_jax) or else
    seeded_parameters(seed), and moves to the inputs' device."""
    cfg = config(name, **size)
    if cfg["config"] == 6:
        model = denoiser(name, **size)
        if params is None:
            seeded_parameters(model, seed)
        else:
            model.load_state_dict(params)
        return _denoiser_step(model)
    knobs = _ALIGN_KNOBS if cfg["config"] in (5, 7) else {}
    search = NonLocalSearch(cfg["ws"], cfg["wt"], cfg["ps"], cfg["K"],
                            nheads=cfg["HD"], self_action="anchor",
                            itype=cfg["itype"], **knobs)
    gather = NonLocalGather(ps=cfg["ps"], stride0=1, itype="int",
                            wt_hint=2 * cfg["wt"]) \
        if cfg["config"] == 1 else None

    def step(vid, *flows):
        v = vid.detach().requires_grad_(cfg["backward"])
        with torch.set_grad_enabled(cfg["backward"]):
            dists, inds = search(v, v, *flows)
            out = dict(dists=dists.detach(), inds=inds.detach())
            if not cfg["backward"]:
                return out
            if gather is None:
                loss = dists.pow(2).mean()
            else:
                weights = torch.softmax(-10. * dists, dim=-1)
                loss = gather(v, weights, inds).pow(2).mean()
            g_vid, = torch.autograd.grad(loss, v)
        return dict(out, loss=loss.detach(), g_vid=g_vid)

    return step

