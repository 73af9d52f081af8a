"""Drive the PyTorch + CUDA port's main path once on one NVIDIA GPU.

Run from the repository root: python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:
  1. the card: name and power limit;
  2. the build of the hand-written CUDA kernels (stnls_tpu_torch/csrc);
  3. each kernel against its plain PyTorch version on the card, at the
     slice config (128^2, wt=2, K=10, stride1=0.5) and the
     __graft_entry__ config (64^2, wt=1, K=8, stride1=1);
  4. the main path at full width (B=1, T=5, F=16, 128^2):
     NonLocalAttention and the bench attention step, through the kernels
     and through the plain versions (`plain_route`), with launch counts;
  5. one backward of the bench step and of NonLocalAttention, against
     the plain route;
  6. times with CUDA events (median of 10 after a warm-up).
The line before the last is a JSON object of the kernels; the last line
is {"ok": true, "device": {...}}. The script imports nothing of JAX.
"""

import contextlib
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

TOL = 1e-4          # atol = rtol for forward outputs and dists (float32)
SEED = 0


def log(*args):
    print(*args, flush=True)


def require(cond, msg):
    if not cond:
        raise AssertionError(msg)


def close(a, b, what, atol=TOL, rtol=TOL):
    same = a == b                       # equal infinities of invalid cells
    diff = (a - b).abs().masked_fill(same, 0.)
    err = float(diff.max())
    ok = bool((diff <= atol + rtol * b.abs()).all())
    require(ok, f"{what}: max |err| {err:.3e} exceeds atol=rtol={TOL}")
    return err


def card_phase(torch):
    require(torch.cuda.is_available(), "no CUDA device: chip_smoke runs on "
            "a GPU only")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    smi_line = smi.stdout.strip().splitlines()[0]
    log(f"[card] {name}; count={torch.cuda.device_count()}")
    log(smi_line)
    return name, smi_line


def build_phase(cuda_lib):
    t0 = time.perf_counter()
    lib = cuda_lib.load()
    secs = time.perf_counter() - t0
    log(f"[build] {'built' if lib.built else 'loaded'} {lib.path.name} "
        f"in {secs:.1f} s")
    # registers and spills of the instantiations the main path launches
    func = None
    for line in lib.log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            func = m.group(1)
        elif func and ("ILi3ELi8E" in func or "agg_gather" in func) and \
                ("registers" in line or "spill" in line):
            log(f"[build] {func[:48]}: {line.strip()}")
    return secs


@contextlib.contextmanager
def plain_route():
    """The reference route on the card: the search and the gather call
    their kernels' plain versions instead of the kernels while inside.
    Swaps the names the main path calls (non_local_search.nls_topk,
    gather.nl_gather_stack) and checks that no kernel launched."""
    from stnls_tpu_torch.search import non_local_search
    from stnls_tpu_torch.agg import gather
    from stnls_tpu_torch.ops import nls_cuda, agg_cuda
    saved = non_local_search.nls_topk, gather.nl_gather_stack
    before = nls_cuda.nls_topk.launches, agg_cuda.nl_gather_stack.launches
    non_local_search.nls_topk = nls_cuda.nls_topk_plain
    gather.nl_gather_stack = agg_cuda.nl_gather_stack_plain
    try:
        yield
    finally:
        non_local_search.nls_topk, gather.nl_gather_stack = saved
    after = nls_cuda.nls_topk.launches, agg_cuda.nl_gather_stack.launches
    require(after == before, "a kernel launched on the plain route")


def make_inputs(torch, rng, dev, *, B, HD, T, F, H, W, wt):
    from stnls_tpu_torch.attn_step import smooth_flows
    from stnls_tpu_torch.nn.flow import search_flow
    vid0 = torch.from_numpy(rng.standard_normal((B, HD, T, F, H, W))
                            .astype(np.float32)).to(dev)
    vid1 = torch.from_numpy(rng.standard_normal((B, HD, T, F, H, W))
                            .astype(np.float32)).to(dev)
    fflow = torch.from_numpy(smooth_flows(rng, (B, T, 2, H, W))).to(dev)
    bflow = torch.from_numpy(smooth_flows(rng, (B, T, 2, H, W))).to(dev)
    flows = search_flow(fflow, bflow, wt, 1)[:, None].contiguous()
    return vid0, vid1, flows


def kernel_phase(torch, dev, name, cfg):
    """B1 and B3 against their plain versions at one config."""
    from stnls_tpu_torch.ops import nls_cuda, agg_cuda
    from stnls_tpu_torch.ops.nls_k import nls_dists_at_cells
    rng = np.random.default_rng(SEED)
    shape = dict(B=1, HD=2, T=5, F=8, H=cfg["H"], W=cfg["H"], wt=cfg["wt"])
    vid0, vid1, flows = make_inputs(torch, rng, dev, **shape)
    kw = dict(ws=5, wt=cfg["wt"], ps=3, stride0=1, stride1=cfg["stride1"],
              k=cfg["k"], anchor=True, dist_type="l2", itype="float")
    with torch.no_grad():
        d_k, c_k = nls_cuda.nls_topk(vid0, vid1, flows, **kw)
        torch.cuda.synchronize()
        d_p, c_p = nls_cuda.nls_topk_plain(vid0, vid1, flows, **kw)
        # the kernel's dists are its cells' true distances ...
        d_rc, _ = nls_dists_at_cells(
            vid0, vid1, flows, c_k, ws=5, wt=cfg["wt"], ps=3, stride0=1,
            stride1=cfg["stride1"])
    err_rc = close(d_k, d_rc, f"B1 {name} dists vs recompute at its cells")
    # ... and the ranked dists agree with the plain version's
    err_b1 = close(d_k, d_p, f"B1 {name} ranked dists vs plain")
    require(bool((c_k[..., 0] == c_p[..., 0]).all()),
            f"B1 {name}: anchored self cells differ")
    share = float((c_k.sort(-1).values != c_p.sort(-1).values).any(-1)
                  .float().mean())
    share_order = float((c_k != c_p).any(-1).float().mean())
    # a differing cell is a near-tie: the plain ranking's neighbouring
    # dists within the tolerance
    gap = (d_p[..., 1:] - d_p[..., :-1]).abs() <= TOL * (1 + d_p[..., 1:].abs())
    tie = torch.zeros_like(c_p, dtype=torch.bool)
    tie[..., 1:] |= gap
    tie[..., :-1] |= gap
    tie[..., -1] = True
    require(bool(((c_k == c_p) | tie).all()),
            f"B1 {name}: a cell differs away from a near-tie")
    require(share < 0.01, f"B1 {name}: {share:.2%} of queries differ")
    log(f"[kernels] B1 {name}: max|dists-plain| {err_b1:.3e}, "
        f"max|dists-recompute| {err_rc:.3e}, queries whose cell set "
        f"differs {share:.4%} (whose order differs {share_order:.4%})")

    # B3 on the search's own weights and offsets
    search_cfg = dict(ws=5, wt=cfg["wt"], ps=3, stride0=1,
                      stride1=cfg["stride1"], dist_type="l2")
    with torch.no_grad():
        d, (dt, dh, dw) = nls_dists_at_cells(vid0, vid1, flows, c_p,
                                             **search_cfg)
        inds = torch.stack([dt, dh, dw], -1)
        inds[..., 0, :] = 0
        weights = torch.softmax(-10. * d, -1).contiguous()
        inds = inds.contiguous()
        s_k = agg_cuda.nl_gather_stack(vid1, weights, inds, ps=3, stride0=1)
        torch.cuda.synchronize()
        s_p = agg_cuda.nl_gather_stack_plain(vid1, weights, inds, ps=3,
                                             stride0=1)
    err_b3 = close(s_k, s_p, f"B3 {name} stack vs plain")
    log(f"[kernels] B3 {name}: max|stack-plain| {err_b3:.3e}")
    return dict(b1=err_b1, b3=err_b3, share=share,
                inputs=(vid0, vid1, flows, weights, inds), kw=kw)


def attn_module(torch, dev):
    """NonLocalAttention with numpy-seeded weights."""
    from stnls_tpu_torch.nn import NonLocalAttention
    attn_cfg = {"nheads": 2, "embed_dim": 8, "use_attn_projection": True,
                "use_attn_flow": True}
    search_cfg = {"search_name": "nls", "ws": 5, "wt": 2, "ps": 3, "k": 10,
                  "nheads": 2, "stride0": 1, "stride1": 0.5,
                  "self_action": "anchor", "itype": "float",
                  "dist_type": "l2"}
    normz_cfg = {"normz_name": "softmax", "normz_scale": 10,
                 "dist_type": "l2"}
    agg_cfg = {"agg_name": "gather", "ps": 3, "stride0": 1,
               "itype": "float"}
    attn = NonLocalAttention(attn_cfg, search_cfg, normz_cfg, agg_cfg)
    rng = np.random.default_rng(SEED + 1)
    state = {}
    for key, val in attn.state_dict().items():
        fan_in = max(1, int(np.prod(val.shape[1:])))
        state[key] = torch.from_numpy(
            (rng.standard_normal(tuple(val.shape)) / np.sqrt(fan_in))
            .astype(np.float32))
    attn.load_state_dict(state)
    return attn.to(dev)


def cuda_ms(torch, fn, n=10, warm=2):
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def main():
    here = Path(__file__).resolve().parent
    if not (here / "stnls_tpu_torch" / "csrc").is_dir():
        sys.exit("chip_smoke: stnls_tpu_torch/ not found beside this script")
    sys.path.insert(0, str(here))
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. the card
    kind, smi_line = card_phase(torch)
    dev = torch.device("cuda", 0)

    from stnls_tpu_torch.ops import cuda_lib, nls_cuda, agg_cuda
    from stnls_tpu_torch.attn_step import AttnStep, smooth_flows
    from stnls_tpu_torch.utils.config import ConfigDict

    # 2. the build
    build_phase(cuda_lib)

    # 3. each kernel against its plain version
    res = kernel_phase(torch, dev, "slice 128^2", dict(H=128, wt=2, k=10,
                                                       stride1=0.5))
    kernel_phase(torch, dev, "graft 64^2", dict(H=64, wt=1, k=8, stride1=1))

    # 4. the main path at full width
    B, T, F, H, W, K = 1, 5, 16, 128, 128, 10
    rng = np.random.default_rng(SEED + 2)
    vid = torch.from_numpy(rng.standard_normal((B, T, F, H, W))
                           .astype(np.float32)).to(dev)
    proj_w = torch.from_numpy((rng.standard_normal((F, F)) / 4.)
                              .astype(np.float32)).to(dev)
    stack_w = torch.from_numpy((rng.standard_normal((K, F, F)) / 8.)
                               .astype(np.float32)).to(dev)
    fflow = torch.from_numpy(smooth_flows(rng, (B, T, 2, H, W))).to(dev)
    bflow = torch.from_numpy(smooth_flows(rng, (B, T, 2, H, W))).to(dev)
    flows = ConfigDict(fflow=fflow, bflow=bflow)
    attn = attn_module(torch, dev)
    step = AttnStep()

    nls_cuda.nls_topk.launches = 0
    agg_cuda.nl_gather_stack.launches = 0
    with torch.no_grad():
        out_attn, _ = attn(vid, flows)
        out_step = step(vid, fflow, bflow, proj_w, stack_w)
    torch.cuda.synchronize()
    launches = {"nls_topk": nls_cuda.nls_topk.launches,
                "nl_gather_stack": agg_cuda.nl_gather_stack.launches}
    log(f"[main] launches on the main path: {launches}")
    require(all(n > 0 for n in launches.values()),
            "a kernel of the main path was never launched")
    with torch.no_grad(), plain_route():
        ref_attn, _ = attn(vid, flows)
        ref_step = step(vid, fflow, bflow, proj_w, stack_w)
    for out, ref, what in ((out_attn, ref_attn, "NonLocalAttention"),
                           (out_step, ref_step, "bench attention step")):
        require(tuple(out.shape) == (B, T, F, H, W),
                f"{what}: shape {tuple(out.shape)}")
        require(bool(torch.isfinite(out).all()), f"{what}: non-finite")
        err = close(out, ref, f"{what} kernels vs plain")
        log(f"[main] {what}: out {tuple(out.shape)}, max|kernels-plain| "
            f"{err:.3e}")

    # 5. one backward: the bench step (q = k there, so softmax(-10 d) puts
    # all weight on the zero-distance self slot and the flow gradient
    # vanishes) and NonLocalAttention (distinct q/k projections, non-zero
    # flow gradient)
    def step_loss(v, f):
        return step(v, f, bflow, proj_w, stack_w).pow(2).mean()

    def attn_loss(v, f):
        return attn(v, ConfigDict(fflow=f, bflow=bflow))[0].pow(2).mean()

    for what, loss_fn in (("bench step", step_loss),
                          ("NonLocalAttention", attn_loss)):
        grads = {}
        for route, ctx in (("kernels", contextlib.nullcontext),
                           ("plain", plain_route)):
            v = vid.clone().requires_grad_()
            f = fflow.clone().requires_grad_()
            with ctx():
                grads[route] = torch.autograd.grad(loss_fn(v, f), (v, f))
        for name, gk, gp in zip(("vid", "fflow"), grads["kernels"],
                                grads["plain"]):
            require(bool(torch.isfinite(gk).all()),
                    f"{what} grad {name}: non-finite")
            scale = float(gp.abs().max())
            err = float((gk - gp).abs().max())
            require(err <= TOL * scale, f"{what} grad {name}: max|err| "
                    f"{err:.3e} > 1e-4 * max|g| = {TOL * scale:.3e}")
            log(f"[backward] {what} grad {name}: max|g| {scale:.3e}, "
                f"max|kernels-plain| {err:.3e}")
        if what == "NonLocalAttention":
            require(float(grads["kernels"][1].abs().max()) > 0,
                    "NonLocalAttention flow gradient vanished")
    log(f"[backward] _gather_bwd_plain calls: "
        f"{agg_cuda._gather_bwd_plain.calls}")

    # 6. times at the slice config
    vid0, vid1, sflows, weights, inds = res["inputs"]
    kw = res["kw"]
    with torch.no_grad():
        t_b1 = cuda_ms(torch, lambda: nls_cuda.nls_topk(vid0, vid1, sflows,
                                                        **kw))
        t_b1p = cuda_ms(torch, lambda: nls_cuda.nls_topk_plain(
            vid0, vid1, sflows, **kw))
        t_b3 = cuda_ms(torch, lambda: agg_cuda.nl_gather_stack(
            vid1, weights, inds, ps=3, stride0=1))
        t_b3p = cuda_ms(torch, lambda: agg_cuda.nl_gather_stack_plain(
            vid1, weights, inds, ps=3, stride0=1))
        t_step = cuda_ms(torch, lambda: step(vid, fflow, bflow, proj_w,
                                             stack_w))
        with plain_route():
            t_stepp = cuda_ms(torch, lambda: step(vid, fflow, bflow, proj_w,
                                                  stack_w))
    log(f"[times] {smi_line}: B1 {t_b1:.3f} ms (plain {t_b1p:.3f}); "
        f"B3 {t_b3:.3f} ms (plain {t_b3p:.3f}); forward step {t_step:.3f} ms"
        f" = {T / (t_step / 1e3):.1f} frames/s (plain {t_stepp:.3f} ms)")

    require("jax" not in sys.modules, "JAX was imported")
    kernels = [
        {"name": "nls_topk_fwd", "route": "cuda",
         "source": "stnls_tpu_torch/csrc/nls_topk_fwd.cu",
         "replaces": "stnls_tpu/ops/nls_pallas.py:761",
         "launches": launches["nls_topk"], "max_abs_err": res["b1"],
         "ms": t_b1, "plain_ms": t_b1p},
        {"name": "agg_gather_fwd", "route": "cuda",
         "source": "stnls_tpu_torch/csrc/agg_gather_fwd.cu",
         "replaces": "stnls_tpu/ops/agg_pallas.py:408",
         "launches": launches["nl_gather_stack"], "max_abs_err": res["b3"],
         "ms": t_b3, "plain_ms": t_b3p},
    ]
    print(json.dumps({"forward_step": {
        "ms": t_step, "plain_ms": t_stepp,
        "frames_per_s": T / (t_step / 1e3)}}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
