"""Profile the attention step of the PyTorch + CUDA port on one NVIDIA
GPU: where the device time of the forward, and of one forward +
backward, goes.

Run from the repository root: python3 profile_step.py

Slice config (B=1, T=5, F=16, HD=2, 128^2, ws=5, wt=2, ps=3, K=10,
stride1=0.5), inputs from numpy seed 0, as chip_smoke.py's main path.
Prints the card's name and power limit, then, before any trace, the
median ms of 10 after 2 warm-ups (CUDA events, attn_step.cuda_ms, the
timer of chip_smoke.py's phase 6) and the peak memory of each of: the
bench attention step's forward, its forward + backward, and
NonLocalAttention's forward + backward. Then:
  - forward: host ms a step under torch.profiler over 5 steps, device ms
    a step (the sum of the device self times), the number of device
    launches a step, and the top device ops;
  - forward + backward: the same of one traced step;
and the same forward + backward for NonLocalAttention
(attn_step.attention_module, seed 1, as chip_smoke.py drives it), whose
search gets a non-zero cotangent (the bench
step's q = k puts all of softmax(-10 d) on the zero-distance self slot,
so its search backward has nothing to do), and for the same module on the
volume path (attn_step.VOLUME_SEARCH: anchor_each, per-frame top-2,
through B5/B6), and for the twin of examples/agg_example.py
(stnls_tpu_torch/agg_example.py: B=1, T=3, F=16, HD=2, 128^2, K=8; its
search, then Gather, GatherAdd, ScatterAdd and Pool forward and backward,
through B1, B3/B4, B7/B8 and B9/B10), and for the steps of
benchmarks/matrix.py's configs 1, 4, 5, 6 and 7 at their published sizes
(stnls_tpu_torch/matrix_steps.py, seed 0; 5 is a forward only; 6 is the
NonLocalDenoiser's train step at 540x960, its loss and its gradients to
every parameter, through B1-B4, parameters seeded 0), for
config 7 through parallel.time_sharded_search on a one-rank NCCL mesh
(chip_smoke.sharded_config7_step: B1/B2 in chunk mode), and for one train step of the twin of
__graft_entry__.dryrun_multichip (stnls_tpu_torch/multichip_step.py) at
the bench slice's widths on that mesh (B=2, T=4). Each
breakdown lists the device ms of the port's ten kernels (B1-B10). The
last line is one JSON object of these numbers.
Exits non-zero without a CUDA device. Imports nothing of JAX.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

STEPS = 5
TOP = 8
# the port's kernels (stnls_tpu_torch/csrc), by their device names
PORT_KERNELS = {"B1": ("nls_topk_kernel",),
                "B2": ("nls_topk_bwd_query_kernel",),
                "B3": ("agg_gather_fwd_pixel_kernel",),
                "B4": ("agg_gather_bwd_tile_kernel",),
                "B5": ("nls_vol_fwd_kernel",), "B6": ("nls_vol_bwd_kernel",),
                "B7": ("agg_scatter_add_fwd_kernel",),
                "B8": ("agg_scatter_add_bwd_tile_kernel",),
                "B9": ("agg_pool_fwd_row_kernel",),
                "B10": ("agg_pool_bwd_kernel",)}
# the kernels' device names in traces before their redesign, where they
# changed
EARLIER_NAMES = {"B2": "nls_topk_bwd_kernel", "B3": "agg_gather_kernel",
                 "B4": "agg_gather_bwd_kernel",
                 "B8": "agg_scatter_add_bwd_vid_kernel, "
                       "agg_scatter_add_bwd_w_kernel",
                 "B9": "agg_pool_fwd_kernel"}


def device_us(evt):
    """Self device time of a profiler row, in microseconds."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return getattr(evt, name)
    return 0.


def trace(torch, fn, steps, dev):
    """Run fn `steps` times under torch.profiler. Returns (host ms a step,
    rows sorted by self device time)."""
    from torch.profiler import profile, ProfilerActivity
    fn()                                             # warm-up outside
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize(dev)
        host_ms = (time.perf_counter() - t0) * 1e3 / steps
    rows = sorted(prof.key_averages(), key=device_us, reverse=True)
    return host_ms, [r for r in rows if device_us(r) > 0]


def summarise(rows, steps, label):
    """Device ms and launches a step, from the device rows (kernels,
    memcpy, memset); the top device rows and the top host ops by the
    device time of the kernels they launched. The port's own kernels are
    launched through ctypes, under no host op: they show among the
    device rows only. The package's spans (utils/spans: stnls.attn.*,
    stnls.search.*, stnls.agg.*) are user annotations, which the profiler
    also gives device rows spanning their kernels: they are left out of
    the device rows, lest those kernels count twice, and show among the
    host op rows."""
    from torch.autograd import DeviceType
    dev_rows = [r for r in rows if r.device_type == DeviceType.CUDA
                and not getattr(r, "is_user_annotation", False)]
    op_rows = [r for r in rows if r.device_type == DeviceType.CPU]
    total_ms = sum(device_us(r) for r in dev_rows) / 1e3 / steps
    launches = sum(r.count for r in dev_rows) / steps
    print(f"[{label}] device {total_ms:.3f} ms a step, {launches:.0f} "
          "device launches a step", flush=True)
    top = {}
    for kind, sel in (("device", dev_rows), ("host op", op_rows)):
        print(f"[{label}] top {kind} rows by self device time:", flush=True)
        top[kind] = []
        for r in sel[:TOP]:
            ms = device_us(r) / 1e3 / steps
            share = ms / total_ms if total_ms else 0.
            print(f"  {ms:9.3f} ms  {share:6.1%}  x{r.count / steps:6.0f}  "
                  f"{r.key[:100]}", flush=True)
            top[kind].append({"name": r.key, "ms": ms, "share": share})
    port = {}
    for key, names in PORT_KERNELS.items():
        hits = [r for r in dev_rows if any(
            f"{name}<" in r.key or f"{name}(" in r.key for name in names)]
        port[key] = sum(device_us(r) for r in hits) / 1e3 / steps
    print(f"[{label}] port kernels, device ms a step: {port}", flush=True)
    top["port kernels"] = port
    return total_ms, launches, top


def timed(torch, dev, fn, T, label):
    """Time of fn by the step timer chip_smoke.py uses (attn_step.cuda_ms:
    median of 10 CUDA-event runs after 2 warm-ups) and its peak memory.
    Run before any trace: a profiler session slows later launches."""
    from stnls_tpu_torch.attn_step import cuda_ms
    torch.cuda.reset_peak_memory_stats(dev)
    ms = cuda_ms(fn)
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"[{label}] median {ms:.3f} ms of 10 = "
          f"{T / (ms / 1e3):.2f} frames/s; peak memory {peak / 1e9:.3f} GB",
          flush=True)
    return ms, peak


def fwd_bwd_breakdown(torch, dev, fn, T, label, ms, peak):
    """The device breakdown of one traced run of fn, beside its untraced
    median `ms` and peak memory."""
    _, rows = trace(torch, fn, 1, dev)
    dev_ms, launches, top = summarise(rows, 1, label)
    return {"ms": ms, "frames_per_s": T / (ms / 1e3), "peak_bytes": peak,
            "device_ms": dev_ms, "launches": launches, "top": top}


def profile(torch, dev, mesh, H=128):
    from stnls_tpu_torch import agg_example, matrix_steps, multichip_step
    from stnls_tpu_torch.attn_step import AttnStep, attention_module, \
        smooth_flows, VOLUME_SEARCH
    from stnls_tpu_torch.utils.config import ConfigDict
    from chip_smoke import sharded_config7_step
    B, T, F, K = 1, 5, 16, 10
    rng = np.random.default_rng(0)

    def t(x):
        return torch.from_numpy(x.astype(np.float32)).to(dev)

    vid = t(rng.standard_normal((B, T, F, H, H)))
    proj_w = t(rng.standard_normal((F, F)) / 4.)
    stack_w = t(rng.standard_normal((K, F, F)) / 8.)
    fflow = t(smooth_flows(rng, (B, T, 2, H, H)))
    bflow = t(smooth_flows(rng, (B, T, 2, H, H)))
    step = AttnStep()

    def fwd():
        with torch.no_grad():
            step(vid, fflow, bflow, proj_w, stack_w)

    def fwd_bwd():
        v = vid.clone().requires_grad_()
        f = fflow.clone().requires_grad_()
        out = step(v, f, bflow, proj_w, stack_w)
        torch.autograd.grad(out.pow(2).mean(), (v, f))

    def attn_fwd_bwd(attn):
        v = vid.clone().requires_grad_()
        f = fflow.clone().requires_grad_()
        out, _ = attn(v, ConfigDict(fflow=f, bflow=bflow))
        params = tuple(attn.parameters())
        torch.autograd.grad(out.pow(2).mean(), (v, f) + params)

    attn = attention_module(1, dev)
    vattn = attention_module(1, dev, search=VOLUME_SEARCH)
    a_in = agg_example.make_inputs(0, device=dev, **agg_example.CONFIG)
    paths = {"NonLocalAttention fwd+bwd": lambda: attn_fwd_bwd(attn),
             "volume NonLocalAttention fwd+bwd": lambda: attn_fwd_bwd(vattn),
             "agg example fwd+bwd": lambda: agg_example.run(*a_in)}
    frames = {"agg example fwd+bwd": agg_example.CONFIG["T"]}
    keys = ["attn_fwd_bwd", "volume_attn_fwd_bwd", "agg_example_fwd_bwd"]
    for name in matrix_steps.CONFIGS:
        m_step = matrix_steps.make_step(name)
        m_in = matrix_steps.make_inputs(name, device=dev)
        paths[f"matrix {name}"] = lambda s=m_step, x=m_in: s(*x)
        frames[f"matrix {name}"] = matrix_steps.CONFIGS[name]["T"]
        keys.append(f"matrix_{name}")
    name = "align1080p_fwd+bwd"
    m_step = sharded_config7_step(torch, mesh)
    m_in = matrix_steps.make_inputs(name, device=dev)
    paths[f"time-sharded matrix {name}"] = lambda: m_step(*m_in)
    frames[f"time-sharded matrix {name}"] = matrix_steps.CONFIGS[name]["T"]
    keys.append(f"time_sharded_matrix_{name}")
    axes = multichip_step.mesh_axes(1)
    t_in = multichip_step.make_inputs(axes, device=dev,
                                      **multichip_step.BENCH_WIDTHS)
    paths["multichip twin train step"] = lambda: multichip_step.train(
        mesh, *t_in)
    frames["multichip twin train step"] = 4 * axes["time"]
    keys.append("multichip_twin_train_step")
    untraced = {label: timed(torch, dev, fn, frames.get(label, T), label)
                for label, fn in (("forward", fwd), ("fwd+bwd", fwd_bwd),
                                  *paths.items())}

    fwd_ms = untraced["forward"][0]
    host_ms, rows = trace(torch, fwd, STEPS, dev)
    dev_ms, launches, top = summarise(rows, STEPS, "forward")
    print(f"[forward] host {host_ms:.3f} ms a step under the profiler",
          flush=True)
    return {"forward": {"ms": fwd_ms, "host_ms": host_ms,
                        "device_ms": dev_ms, "launches": launches,
                        "top": top},
            "fwd_bwd": fwd_bwd_breakdown(torch, dev, fwd_bwd, T, "fwd+bwd",
                                         *untraced["fwd+bwd"]),
            **{key: fwd_bwd_breakdown(torch, dev, fn, frames.get(label, T),
                                      label, *untraced[label])
               for key, (label, fn) in zip(keys, paths.items())}}


def main():
    here = Path(__file__).resolve().parent
    if not (here / "stnls_tpu_torch" / "csrc").is_dir():
        sys.exit("profile_step: stnls_tpu_torch/ not found beside this "
                 "script")
    sys.path.insert(0, str(here))
    import torch
    if not torch.cuda.is_available():
        sys.exit("profile_step: no CUDA device; it profiles a GPU only")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    smi_line = smi.stdout.strip().splitlines()[0] if smi.stdout else ""
    print(smi_line, flush=True)
    for key, old in EARLIER_NAMES.items():
        print(f"[kernels] {key}: traced as {', '.join(PORT_KERNELS[key])} "
              f"(before its redesign: {old})", flush=True)
    from stnls_tpu_torch.multichip_step import one_rank_mesh
    torch.cuda.set_device(0)
    with one_rank_mesh() as mesh:
        res = profile(torch, torch.device("cuda", 0), mesh)
    print(json.dumps(dict(res, card=smi_line)))


if __name__ == "__main__":
    main()
