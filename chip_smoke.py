"""Drive the PyTorch + CUDA port's main paths once on one NVIDIA GPU.

Run from the repository root: python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:
  1. the card: name and power limit;
  2. the build of the hand-written CUDA kernels (stnls_tpu_torch/csrc);
  3. each kernel against its plain PyTorch version on the card, at the
     slice config (128^2, wt=2, K=10, stride1=0.5) and the
     __graft_entry__ config (64^2, wt=1, K=8, stride1=1): B1 search
     top-K, B2 search backward, B3 gather, B4 gather backward, B5 search
     volume and B6 its backward (on a dense cotangent, as
     topk_mode="none" gives, and on the sparse one of anchor_each with
     per-frame top-2; at 64^2 also remove_ref_frame's, the int path and
     prod distances; centre gradients compared off integer lattice
     positions);
  4. the forward path at full width (B=1, T=5, F=16, 128^2):
     NonLocalAttention and the bench attention step, through the kernels
     and through the plain versions (`plain_route`), with launch counts;
  5. the training path at full width: forward and backward of the bench
     step and of NonLocalAttention into the video, the flows and the
     parameters, then 3 SGD steps of NonLocalAttention towards a fixed
     target, through the kernels (launch counts of B1-B4, no plain
     backward called), through the plain backwards on the kernels'
     forward and through the plain route; gradients and each parameter's
     SGD update compared at 1e-4 * max|ref|, or at 1e-3 where the failing
     element's own queries show a softmax near-tie (near_tie); elements
     of a video or flow in reach of a query whose cells differ between
     the routes at a near-tie of its dists are left out and counted
     (flipped_reach);
  6. the volume path at full width: NonLocalAttention with the search
     self_action="anchor_each", topk_mode="each", k=2 (K = W_t * k = 10)
     through B5, B6, B3 and B4, forward (outputs at 1e-4 away from the
     flipped near-ties, counted), backward into the video, the flows and
     the parameters, and 3 SGD steps, against the plain backwards on the
     kernels' forward and against the plain route, under the rules of
     phase 5;
  7. times with CUDA events (median after warm-ups);
  8. the aggregation kernels against their plain versions on the card:
     B7 ScatterAdd and B9 PooledPatchSum forwards, B8 and B10 their
     backwards on a seeded cotangent, at the agg example's config (128^2,
     its search's weights and offsets) and at a second one (64^2, strides
     2, dilation 2, use_adj, ps 4 (pool: 5), pt 2, half-integer offsets,
     -1e8 fills, weights below 1e-8 and negative);
  9. the agg example's twin (stnls_tpu_torch/agg_example.py) at full width
     (B=1, T=3, F=16, HD=2, 128^2, K=8): one search, then Gather,
     GatherAdd, ScatterAdd and Pool forward and the gradients of
     mean(out^2) to the video, the weights and the offsets, through the
     kernels (launch counts of B1, B3, B4, B7-B10; no plain backward) and
     through the plain route on the same search outputs; every gradient
     compared is non-zero, the offsets' gradients of ScatterAdd and Pool
     are exactly 0;
 10. the times of B7-B10 and of the twin;
 11. B1, B5 and B6 against their plain versions at (ps, F a head) other
     than the slice's, on 48^2 frames: ps 1, 5 and 7 with F 2, 4, 16 and
     32, among them dilation 2, use_adj, prod, int, stride0 = 2 and an
     anchored K = 65 (64 ranked slots); B1's and B5's dists bitwise equal
     to the plain volume's, B6 at 1e-4 * max|ref|; then a K = 100 search,
     which must run on the volume route (B5, no B1);
 12. benchmarks/matrix.py's search-only configs 1, 4, 5 and 7
     (stnls_tpu_torch/matrix_steps.py) at their published sizes through
     the kernels: shapes, finite values, launch counts, no plain backward,
     peak memory, and (q = k) dist 0 in the anchored slot 0 with the other
     slots ascending; against the plain route at full size for 1 and 4 and
     on a 270x480 crop for 5 and 7, under the rules of phase 5;
 13. times: the four matrix steps; B1, B5 and B6 at (ps, F a head) =
     (1, 2) and (1, 16) against their plain versions, with their bounds;
     the bodies of B1 and B5 with (ps, F) compiled in ((3, 8); B5 also
     (3, 16)) against the run-time body;
 14. time sharding (stnls_tpu_torch/parallel), the temporal-chunk mode
     of B1, B2, B5 and B6: (a) each against its plain chunk version, B1
     and B5 bitwise (B1's cells too, compiled and run-time bodies), B2
     and B6 at 1e-4 * max|ref| on seeded cotangents, at the slice's (3, 8)
     on 128^2 (8 frames in chunks of 4 with halos of 4, t0 = 0 and 4,
     float and int) and at (1, 2) on the 270x480 crop of config 7's
     inputs (chunks of 5, halos of 6); (b) the chunks joined over the
     sequence equal the whole video's B1 and B5 bitwise at the slice
     shape, and B1's on config 7's whole 1080p frames, head by head;
     their times against the plain versions with their bounds; (c)
     time_sharded_search on a one-rank NCCL mesh at config 7's published
     size, forward and backward into the video, against the config-7
     step of phase 12 (dists and offsets equal, launch counts, times in
     turns, peak memory), and on the volume route at the slice's widths
     (K = 80) against plain_route(); (d) the twin of
     __graft_entry__.dryrun_multichip (stnls_tpu_torch/multichip_step.py)
     at the bench slice's widths (B=2, T=4) on that mesh, 3 SGD steps
     through the kernels (B1-B4) and through plain_route(). A multi-card
     ring exchange is not run: one card holds one rank.
The line before the last is a JSON object of the kernels (B1, B2, B5 and
B6 with a "chunk" entry of their chunk mode); the last line is
{"ok": true, "device": {...}}. The script imports nothing of JAX.
"""

import contextlib
import copy
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

TOL = 1e-4          # atol = rtol for forward outputs and dists (float32);
                    # gradients and SGD updates: 1e-4 * max|ref|
# A gradient element of the kernel route that misses TOL against a route
# with another forward (or other parameters) is held to NEAR_TIE_TOL only
# where its own queries show the cause, a near-tie of the search: the two
# routes' dists there agree to TOL (float rounding, summation order), and
# a query's softmax(-10 d) weights moved by more than TOL, or its cells
# differ, at those equal dists (near_tie). Elsewhere TOL holds. Where a
# query's cells differ at such a tie, the routes gather other patches
# there: the video and flow elements in its reach are left out and
# counted (flipped_reach); per-frame top-2 flips carry real weight.
NEAR_TIE_TOL = 1e-3
NORMZ_SCALE = 10.
SEED = 0
LR, SGD_STEPS = 0.5, 3
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and float32 (non-tensor)
# flop/s, for the bound of each kernel
HBM_BYTES_S, F32_FLOP_S = 3.35e12, 67e12
# The float arithmetic each function needs per (query, slot, patch tap,
# channel), not the kernels' own instruction mix. B1: bilinear read (4 mul
# + 3 add) + l2 (sub, mul, add). B2: bilinear read (7) + the cotangent
# 2g (p0 - pv) (sub, mul; 2g once per pair, its negation folded into the
# corner weights) + 1 add into g_vid0 + 4 corner products and 4 adds into
# g_vid1 + 4 multiply-adds of the corner sums S_c = sum gpv * c, from
# which both position gradients follow once per pair. B3: bilinear read
# (7) + weight and sum (2). B4: one multiply-add per corner sum (8; the
# weight and offset gradients follow from the four sums once per pair)
# + g * w (1) + 4 corner products and 4 adds into g_vid; the division by
# the overlap count is counted once per cotangent element (bounds below).
# B5 computes B1's arithmetic for every window cell, B6 B2's for every
# cell with a cotangent. The aggregation kernels count per (query, slot,
# frame step, patch tap) the function keeps, and channel: B7 w * v and
# its add into out (2), for the terms of a non-zero weight. B8: w * g and
# its add into g_vid (2) for those terms, and v * g and its add into g_w
# (2) for every in-frame term (a zero weight still has a gradient). B9:
# as B7 (2), for the terms of a weight >= 1e-8, plus the division by the
# count once per output element. B10: w * g and v * g and their adds (4)
# for those terms, plus the cotangent's division once per element.
FLOPS_PER_TAP = {"B1": 10, "B2": 26, "B3": 9, "B4": 17, "B5": 10, "B6": 26,
                 "B7": 2, "B8": 2, "B9": 2, "B10": 4}
# The search of the volume path (attn_step.VOLUME_SEARCH) and the
# configurations of the B5/B6 checks: (label, itype, dist_type, the
# cotangents B6 is checked on)
VOLUME_CASES = {
    128: (("float l2", "float", "l2", ("each", "dense")),),
    64: (("float l2", "float", "l2", ("each", "dense", "remove_ref_frame")),
         ("int l2", "int", "l2", ("each",)),
         ("float prod", "float", "prod", ("dense",)))}


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


def grad_close(g, ref, what):
    """|g - ref| <= 1e-4 * max|ref|: atomics sum in another order."""
    require(bool(g.isfinite().all()), f"{what}: non-finite")
    scale = float(ref.abs().max())
    err = float((g - ref).abs().max()) if g.numel() else 0.
    require(err <= TOL * scale, f"{what}: max|err| {err:.3e} > 1e-4 * "
            f"max|g| = {TOL * scale:.3e}")
    return err, scale


def off_integer(x, eps=1e-3):
    """Coordinates away from the bilinear kinks at integers, where the
    position derivatives jump."""
    frac = x - x.floor()
    return (frac > eps) & (frac < 1 - eps)


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
    # registers and spills of the kernels the main paths launch
    func = None
    for line in lib.log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            func = m.group(1)
        elif func and ("ILi3ELi8E" in func or "ILi0ELi0E" in func
                       or "agg_" in func or "nls_topk_bwd" in func) and \
                ("registers" in line or "spill" in line):
            log(f"[build] {func[:48]}: {line.strip()}")
    return secs


def counters():
    """The launch counts of the ten kernels and the call counts of the
    plain backwards, by name."""
    from stnls_tpu_torch.ops import nls_cuda, nls_vol_cuda, agg_cuda, \
        agg_sp_cuda as sp
    return {"nls_topk_fwd": nls_cuda.nls_topk,
            "nls_topk_bwd": nls_cuda.nls_topk_bwd,
            "agg_gather_fwd": agg_cuda.nl_gather_stack,
            "agg_gather_bwd": agg_cuda.nl_gather_stack_bwd,
            "nls_vol_fwd": nls_vol_cuda.nls_volume,
            "nls_vol_bwd": nls_vol_cuda.nls_volume_bwd,
            "agg_scatter_add_fwd": sp.nl_scatter_add,
            "agg_scatter_add_bwd": sp.nl_scatter_add_bwd,
            "agg_pool_fwd": sp.nl_pool,
            "agg_pool_bwd": sp.nl_pool_bwd}, \
        {"nls_topk_bwd_plain": nls_cuda.nls_topk_bwd_plain,
         "_gather_bwd_plain": agg_cuda._gather_bwd_plain,
         "nls_volume_bwd_plain": nls_vol_cuda.nls_volume_bwd_plain,
         "_scatter_add_bwd_plain": sp._scatter_add_bwd_plain,
         "_pool_bwd_plain": sp._pool_bwd_plain}


def reset_counts():
    kernels, plains = counters()
    for fn in kernels.values():
        fn.launches = 0
    for fn in plains.values():
        fn.calls = 0


def read_counts():
    kernels, plains = counters()
    return ({k: fn.launches for k, fn in kernels.items()},
            {k: fn.calls for k, fn in plains.items()})


@contextlib.contextmanager
def plain_route(forward=True):
    """The reference route on the card: the search and the aggregators
    call their kernels' plain versions instead of the kernels while
    inside. Swaps the names the main paths call (the backwards
    nls_cuda.nls_topk_bwd, nls_vol_cuda.nls_volume_bwd,
    agg_cuda.nl_gather_stack_bwd, agg_sp_cuda.nl_scatter_add_bwd and
    agg_sp_cuda.nl_pool_bwd and, with `forward`, non_local_search.nls_topk,
    nls_vol_cuda.nls_volume, gather.nl_gather_stack,
    gather_add.nl_gather_stack, scatter_add.nl_scatter_add and
    pool.nl_pool) and checks that none of the swapped kernels launched."""
    from stnls_tpu_torch.search import non_local_search
    from stnls_tpu_torch.agg import gather, gather_add, scatter_add, pool
    from stnls_tpu_torch.ops import nls_cuda, nls_vol_cuda, agg_cuda, \
        agg_sp_cuda as sp
    names = [(nls_cuda, "nls_topk_bwd", nls_cuda.nls_topk_bwd_plain),
             (nls_vol_cuda, "nls_volume_bwd",
              nls_vol_cuda.nls_volume_bwd_plain),
             (agg_cuda, "nl_gather_stack_bwd", agg_cuda._gather_bwd_plain),
             (sp, "nl_scatter_add_bwd", sp._scatter_add_bwd_plain),
             (sp, "nl_pool_bwd", sp._pool_bwd_plain)]
    if forward:
        names += [(non_local_search, "nls_topk", nls_cuda.nls_topk_plain),
                  (nls_vol_cuda, "nls_volume",
                   nls_vol_cuda.nls_volume_plain),
                  (gather, "nl_gather_stack",
                   agg_cuda.nl_gather_stack_plain),
                  (gather_add, "nl_gather_stack",
                   agg_cuda.nl_gather_stack_plain),
                  (scatter_add, "nl_scatter_add", sp.nl_scatter_add_plain),
                  (pool, "nl_pool", sp.nl_pool_plain)]
    saved = [getattr(mod, name) for mod, name, _ in names]
    before = read_counts()[0]
    for mod, name, plain in names:
        setattr(mod, name, plain)
    try:
        yield
    finally:
        for (mod, name, _), fn in zip(names, saved):
            setattr(mod, name, fn)
    after = read_counts()[0]
    swapped = after if forward else {k: after[k] for k in (
        "nls_topk_bwd", "nls_vol_bwd", "agg_gather_bwd",
        "agg_scatter_add_bwd", "agg_pool_bwd")}
    require(all(after[k] == before[k] for k in swapped),
            "a swapped kernel launched on the plain route")


def make_inputs(torch, rng, dev, *, B, HD, T, F, H, W, wt, stride0=1):
    """Seeded videos [B,HD,T,F,H,W] and the search flows of smooth fflow
    and bflow on the stride0 query grid, [B,1,T,W_t-1,2,nH,nW]."""
    from stnls_tpu_torch.attn_step import smooth_flows
    from stnls_tpu_torch.nn.flow import search_flow
    vid0 = torch.from_numpy(rng.standard_normal((B, HD, T, F, H, W))
                            .astype(np.float32)).to(dev)
    vid1 = torch.from_numpy(rng.standard_normal((B, HD, T, F, H, W))
                            .astype(np.float32)).to(dev)
    fflow = torch.from_numpy(smooth_flows(rng, (B, T, 2, H, W))).to(dev)
    bflow = torch.from_numpy(smooth_flows(rng, (B, T, 2, H, W))).to(dev)
    flows = search_flow(fflow, bflow, wt, stride0)[:, None].contiguous()
    return vid0, vid1, flows


def taps_in_frame(n, L, ps, stride0=1):
    """(query, tap) pairs along one axis whose reference pixel lies in
    the frame: the taps the gather and its backward compute."""
    pos = np.arange(n)[:, None] * stride0 + np.arange(ps)[None] - ps // 2
    return int(((pos >= 0) & (pos < L)).sum())


def bound_ms(nbytes, flops):
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the float32 peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / F32_FLOP_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops \
        else "operations"


def kernel_phase(torch, dev, name, cfg):
    """B1-B4 against their plain versions at one config."""
    from stnls_tpu_torch.ops import nls_cuda, agg_cuda
    from stnls_tpu_torch.ops.nls_k import nls_dists_at_cells, cells_geometry
    rng = np.random.default_rng(SEED)
    B, HD, T, F, H = 1, 2, 5, 8, cfg["H"]
    shape = dict(B=B, HD=HD, T=T, F=F, H=H, W=H, wt=cfg["wt"])
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

    # B2 at the kernel's cells, on a seeded cotangent
    geo = cells_geometry(flows, c_k, H=H, W=H, ws=5, wt=cfg["wt"], stride0=1,
                         stride1=cfg["stride1"])
    g_d = torch.from_numpy(rng.standard_normal(tuple(c_k.shape))
                           .astype(np.float32)).to(dev)
    bwd_cfg = dict(ps=3, stride0=1, dist_type="l2", dilation=1,
                   use_adj=False, itype="float")
    b2_args = (vid0, vid1, geo["prop_h"], geo["prop_w"], geo["tj_k"],
               geo["valid"], g_d, bwd_cfg)
    g_k = nls_cuda.nls_topk_bwd(*b2_args)
    torch.cuda.synchronize()
    g_p = nls_cuda.nls_topk_bwd_plain(*b2_args)
    off = off_integer(geo["prop_h"]) & off_integer(geo["prop_w"])
    errs_b2 = []
    for gk, gp, what, mask in zip(g_k, g_p, ("g_vid0", "g_vid1", "g_prop_h",
                                             "g_prop_w"),
                                  (None, None, off, off)):
        if mask is not None:
            gk, gp = gk[mask], gp[mask]
        err, scale = grad_close(gk, gp, f"B2 {name} {what}")
        errs_b2.append(err)
        log(f"[kernels] B2 {name} {what}: max|g| {scale:.3e}, "
            f"max|kernel-plain| {err:.3e}")
    log(f"[kernels] B2 {name}: position gradients compared at "
        f"{int(off.sum())} of {off.numel()} (q, k) off integer coordinates")

    # B3 and B4 on the search's own weights and offsets
    with torch.no_grad():
        d, (dt, dh, dw) = nls_dists_at_cells(
            vid0, vid1, flows, c_p, ws=5, wt=cfg["wt"], ps=3, stride0=1,
            stride1=cfg["stride1"], dist_type="l2")
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

    g_stack = torch.from_numpy(rng.standard_normal(tuple(s_k.shape))
                               .astype(np.float32)).to(dev)
    agg_cfg = dict(ps=3, stride0=1, pt=1, dilation=1, reflect_bounds=True,
                   use_adj=False, itype="float")
    b4_args = (vid1, weights, inds, g_stack, agg_cfg, (True, True, True))
    g_k = agg_cuda.nl_gather_stack_bwd(*b4_args)
    torch.cuda.synchronize()
    g_p = agg_cuda._gather_bwd_plain(*b4_args)
    off = off_integer(inds[..., 1]) & off_integer(inds[..., 2])
    require(not bool(g_k[2][..., 0].any()), f"B4 {name}: dt gradient")
    errs_b4 = []
    for gk, gp, what in zip(g_k, g_p, ("g_vid", "g_weights", "g_flows")):
        if what == "g_flows":
            gk, gp = gk[..., 1:][off], gp[..., 1:][off]
        err, scale = grad_close(gk, gp, f"B4 {name} {what}")
        errs_b4.append(err)
        log(f"[kernels] B4 {name} {what}: max|g| {scale:.3e}, "
            f"max|kernel-plain| {err:.3e}")
    log(f"[kernels] B4 {name}: offset gradients compared at "
        f"{int(off.sum())} of {off.numel()} (q, k) off integer coordinates")

    # bounds at this config, from these inputs
    def nb(*xs):
        return sum(x.numel() * x.element_size() for x in xs)

    nq = B * HD * T * H * H
    K = c_k.shape[-1]
    ps = kw["ps"]
    cells_all = (min(2 * cfg["wt"] + 1, T)) * 25      # full_ws: all valid
    taps = taps_in_frame(H, H, ps) ** 2 * B * HD * T * K   # (q, k, tap)
    active = int((geo["valid"] & (g_d != 0)).sum())
    bounds = {
        "B1": bound_ms(nb(vid0, vid1, flows, d_k, c_k),
                       nq * cells_all * ps * ps * F * FLOPS_PER_TAP["B1"]),
        "B2": bound_ms(nb(vid0, vid1, geo["prop_h"], geo["prop_w"],
                          geo["tj_k"].int(), g_d)
                       + nb(vid0, vid1, geo["prop_h"], geo["prop_w"]),
                       active * ps * ps * F * FLOPS_PER_TAP["B2"]),
        "B3": bound_ms(nb(vid1, weights, inds, s_k),
                       taps * F * FLOPS_PER_TAP["B3"] + s_k.numel()),
        "B4": bound_ms(nb(vid1, weights, inds, g_stack) + nb(vid1, weights,
                                                             inds),
                       taps * F * FLOPS_PER_TAP["B4"] + g_stack.numel()),
    }
    return dict(err={"B1": err_b1, "B2": max(errs_b2), "B3": err_b3,
                     "B4": max(errs_b4)}, share=share, bounds=bounds,
                inputs=(vid0, vid1, flows, weights, inds), kw=kw,
                b2_args=b2_args, b4_args=b4_args)


def volume_cotangent(torch, rng, d, inds3, kind, wt):
    """A cotangent of the volume d [B,HD,T,W_t,ws,ws,nH,nW]: "dense"
    (every cell, as topk_mode="none" gives), or the sparse one that
    _self_action_topk gives to a seeded cotangent of its output: "each"
    (anchor_each, per-frame top-2), "remove_ref_frame" (top-10 of the
    other frames)."""
    from stnls_tpu_torch.search.non_local_search import _self_action_topk
    if kind == "dense":
        return torch.from_numpy(rng.standard_normal(tuple(d.shape))
                                .astype(np.float32)).to(d.device)
    sa, mode, k = {"each": ("anchor_each", "each", 2),
                   "remove_ref_frame": ("remove_ref_frame", "all", 10)}[kind]
    d = d.detach().requires_grad_()
    with torch.enable_grad():
        ds, _ = _self_action_topk(d, inds3, self_action=sa, topk_mode=mode,
                                  k=k, wt=wt, dist_type="l2")
        g = torch.from_numpy(rng.standard_normal(tuple(ds.shape))
                             .astype(np.float32)).to(d.device)
        g_d, = torch.autograd.grad(ds, d, g)
    return g_d


def volume_kernel_phase(torch, dev, name, cfg):
    """B5 and B6 against their plain versions at one config, for each of
    its VOLUME_CASES; the plain B6 runs one (batch, head) slice at a time,
    and its peak memory is printed. Returns the largest errors, the
    bounds, and the arguments of the first case for the timings."""
    from stnls_tpu_torch.ops import nls_vol_cuda
    from stnls_tpu_torch.ops.nls import search_centres
    from stnls_tpu_torch.ops.nls_k import search_aux, aux_to_inds3
    rng = np.random.default_rng(SEED + 3)
    B, HD, T, F, H = 1, 2, 5, 8, cfg["H"]
    wt = cfg["wt"]
    vid0, vid1, flows = make_inputs(torch, rng, dev, B=B, HD=HD, T=T, F=F,
                                    H=H, W=H, wt=wt)
    errs = {"B5": 0., "B6": 0.}
    res = {}
    for label, itype, dist_type, cotangents in VOLUME_CASES[H]:
        stride1 = cfg["stride1"] if itype == "float" else 1
        ctr_h, ctr_w = search_centres(vid0.shape, flows, wt=wt, stride0=1,
                                      itype=itype)
        kw = dict(ws=5, wt=wt, ps=3, stride0=1, stride1=stride1,
                  dist_type=dist_type, itype=itype)
        with torch.no_grad():
            d = nls_vol_cuda.nls_volume(vid0, vid1, ctr_h, ctr_w, **kw)
            torch.cuda.synchronize()
            d_p = nls_vol_cuda.nls_volume_plain(vid0, vid1, ctr_h, ctr_w,
                                                **kw)
        require(bool((d.isinf() == d_p.isinf()).all()),
                f"B5 {name} {label}: invalid cells differ")
        err = close(d, d_p, f"B5 {name} {label} volume vs plain")
        errs["B5"] = max(errs["B5"], err)
        log(f"[kernels] B5 {name} {label}: max|volume-plain| {err:.3e}, "
            f"{int(d.isinf().sum())} of {d.numel()} cells outside the frame")
        aux = search_aux(vid0.shape, flows, ws=5, wt=wt, stride0=1,
                         stride1=stride1, itype=itype)
        inds3 = aux_to_inds3(aux, d.shape)
        off = (off_integer(aux["dh"]).all(4), off_integer(aux["dw"]).all(4))
        bwd_cfg = dict(kw, dilation=1, full_ws=True, use_adj=False)
        for kind in cotangents:
            g_d = volume_cotangent(torch, rng, d, inds3, kind, wt)
            args = (vid0, vid1, ctr_h, ctr_w, g_d, bwd_cfg)
            g_k = nls_vol_cuda.nls_volume_bwd(*args)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            g_p = nls_vol_cuda.nls_volume_bwd_plain(*args)
            peak = (torch.cuda.max_memory_allocated(dev) - base) / 1e9
            for gk, gp, what, mask in zip(g_k, g_p, ("g_vid0", "g_vid1",
                                                     "g_ctr_h", "g_ctr_w"),
                                          (None, None) + off):
                if mask is not None and itype == "int":
                    require(not gk.any() and not gp.any(),
                            f"B6 {name} {label}: int-path {what} not 0")
                    continue
                if mask is not None:
                    gk, gp = gk[mask], gp[mask]
                err, scale = grad_close(gk, gp, f"B6 {name} {label} {kind} "
                                        f"{what}")
                errs["B6"] = max(errs["B6"], err)
                log(f"[kernels] B6 {name} {label} {kind} {what}: max|g| "
                    f"{scale:.3e}, max|kernel-plain| {err:.3e}")
            active = int(((g_d != 0) & d.isfinite()).sum())
            log(f"[kernels] B6 {name} {label} {kind}: {active} of "
                f"{g_d.numel()} cells carry a cotangent; centre gradients "
                f"compared at {int(off[0].sum())} (h) and {int(off[1].sum())}"
                f" (w) of {off[0].numel()} (query, slot) off integer "
                f"lattice positions; plain B6 peak {peak:.3f} GB")
            res.setdefault(kind, dict(args=args, active=active,
                                      kw=kw, g=(g_k, g_d)))

    def nb(*xs):
        return sum(x.numel() * x.element_size() for x in xs)

    first = res["each"]
    vid0, vid1, ctr_h, ctr_w, g_d, _ = first["args"]
    with torch.no_grad():
        d = nls_vol_cuda.nls_volume(vid0, vid1, ctr_h, ctr_w, **first["kw"])
    valid = int(d.isfinite().sum())
    taps = first["kw"]["ps"] ** 2
    bounds = {"B5": bound_ms(nb(vid0, vid1, ctr_h, ctr_w, d),
                             valid * taps * F * FLOPS_PER_TAP["B5"])}
    for kind, r in res.items():
        bounds[f"B6 {kind}"] = bound_ms(
            nb(*r["args"][:5]) + nb(*r["g"][0]),
            r["active"] * taps * F * FLOPS_PER_TAP["B6"])
    return dict(err=errs, bounds=bounds, b5_args=(vid0, vid1, ctr_h, ctr_w),
                b5_kw=first["kw"],
                b6_args={kind: r["args"] for kind, r in res.items()})


def train_path(torch, attn, step, data):
    """The training path: forward and backward of the bench step and of
    NonLocalAttention into the video, the flows and the parameters, then
    SGD_STEPS steps of plain SGD of a copy of NonLocalAttention towards
    the fixed target (attn_train_path). Returns the gradients, the SGD
    updates, the trained copy and the losses."""
    vid, fflow, bflow, proj_w, stack_w, target = data
    leaves = [x.clone().requires_grad_() for x in (vid, fflow, proj_w,
                                                   stack_w)]
    loss = step(leaves[0], leaves[1], bflow, leaves[2], leaves[3]) \
        .pow(2).mean()
    grads = {"bench step": dict(zip(("vid", "fflow", "proj_w", "stack_w"),
                                    torch.autograd.grad(loss, leaves)))}
    attn_grads, updates, model, losses = attn_train_path(torch, attn, data)
    grads.update(attn_grads)
    return grads, updates, model, losses


def attn_train_path(torch, attn, data):
    """Forward and backward of NonLocalAttention `attn` into the video,
    the flows and the parameters, then SGD_STEPS steps of plain SGD of a
    copy of it towards the fixed target. Returns the gradients, the SGD
    updates (each parameter's sum over the steps of LR * grad: its change,
    without the rounding of p - LR * grad at |p|), the trained copy and
    the losses."""
    from stnls_tpu_torch.utils.config import ConfigDict
    vid, fflow, bflow, proj_w, stack_w, target = data
    grads = {}
    model = copy.deepcopy(attn)
    names, params = zip(*model.named_parameters())
    v, f = vid.clone().requires_grad_(), fflow.clone().requires_grad_()
    loss = model(v, ConfigDict(fflow=f, bflow=bflow))[0].pow(2).mean()
    grads["NonLocalAttention"] = dict(zip(
        ("vid", "fflow") + names,
        torch.autograd.grad(loss, (v, f) + params)))
    flows = ConfigDict(fflow=fflow, bflow=bflow)
    losses = []
    updates = {n: torch.zeros_like(p) for n, p in zip(names, params)}
    for _ in range(SGD_STEPS):
        model.zero_grad()
        loss = (model(vid, flows)[0] - target).pow(2).mean()
        loss.backward()
        losses.append(float(loss.detach()))
        with torch.no_grad():
            for n, p in model.named_parameters():
                u = LR * p.grad
                p -= u
                updates[n] += u
    return grads, updates, model, losses


def route_search(torch, what, model, step, data):
    """The (dists, offsets) of the search of path `what` (the bench step,
    or NonLocalAttention `model`) on the route in force."""
    from stnls_tpu_torch.nn.flow import search_flow
    from stnls_tpu_torch.nn.utils import rescale_flows
    from stnls_tpu_torch.utils.config import ConfigDict
    vid, fflow, bflow, proj_w = data[:4]
    with torch.no_grad():
        if what == "bench step":
            q = torch.einsum("btchw,cd->btdhw", vid, proj_w)
            return step.search(q, q, search_flow(fflow, bflow, step.wt,
                                                 step.stride0))
        fl = rescale_flows(ConfigDict(fflow=fflow, bflow=bflow),
                           *vid.shape[-2:])
        q, k, _ = model.get_qkv(vid)
        return model.search(q, k, fl.fflow, fl.bflow)


def near_tie(torch, idx, shape, ours, ref, *, wt, ps):
    """Whether the element `idx` of a gradient of `shape` lies in reach
    of a softmax near-tie of the search, and the evidence. ours, ref: the
    two routes' (dists [B,HD,T,nH,nW,K], offsets [..,K,3]).

    A pixel of a video or flow gradient [B,T,C,H,W] is reached by the
    queries of frames t-wt..t+wt within ps//2 + 1 + max|offset| pixels
    (its query patch, or its key patch at an offset, bilinear); an element
    of a parameter by every query. In reach, the routes' sorted dists must
    agree to TOL (float rounding; sorted, so that cells swapped at a tie
    compare), and one query must show the tie: either its softmax(-10 d)
    weights (of the sorted dists) moved by more than TOL, which rounding
    far below TOL can do only where its best weights are of one size, or
    its cells differ between the routes at equal dists (a ranking tie).
    The ranking tie alone (best dists within TOL * (1 + |d|)) is too
    narrow: the softmax is steep wherever its two best dists lie within
    about 1 / NORMZ_SCALE."""
    (d_o, i_o), (d_r, i_r) = ours, ref
    B, HD, T, nH, nW, K = d_r.shape
    reach = torch.ones((B, HD, T, nH, nW), dtype=torch.bool,
                       device=d_r.device)
    if len(shape) == 5 and shape[1] == T and tuple(shape[-2:]) == (nH, nW):
        b, t, _, h, w = idx
        off = max(float(i[..., 1:].abs().max()) for i in (i_o, i_r))
        R = ps // 2 + 1 + int(np.ceil(off))
        reach = torch.zeros_like(reach)
        reach[b, :, max(0, t - wt):t + wt + 1, max(0, h - R):h + R + 1,
              max(0, w - R):w + R + 1] = True
    s_o, s_r = d_o.sort(-1).values, d_r.sort(-1).values
    agree = ((s_o == s_r) | ((s_o - s_r).abs() <= TOL * (1 + s_r.abs()))) \
        .all(-1)
    w_gap = (torch.softmax(-NORMZ_SCALE * s_o, -1)
             - torch.softmax(-NORMZ_SCALE * s_r, -1)).abs().amax(-1)
    swap = (i_o != i_r).any(-1).any(-1)
    cand = reach & ((w_gap > TOL) | swap)
    where = f"{int(reach.sum())} queries in reach"
    if not bool(agree[reach].all()):
        return False, f"{where}: the routes' dists differ by more than TOL"
    if not bool(cand.any()):
        return False, (f"{where}: no weight moved by more than TOL and no "
                       "cell differs")
    j = np.unravel_index(int(torch.where(cand, w_gap, -1.).argmax()),
                         tuple(cand.shape))
    return True, (
        f"{where}, their dists agree to TOL; at query (b, head, t, h, w) "
        f"{tuple(int(x) for x in j)} softmax(-10 d) moved by "
        f"{float(w_gap[j]):.3e}{', its cells differ' if swap[j] else ''}, "
        f"its best dists {s_o[j][:3].tolist()} (this route) and "
        f"{s_r[j][:3].tolist()} (reference)")


def flipped_reach(torch, shape, ours, ref, *, wt, ps, output=False):
    """The elements of a video-shaped tensor [B,T,C,H,W] in reach (as in
    near_tie; with `output`, of the attention's output: the query's own
    frame within ps//2, the gather's patch fold, the projections being
    1x1) of a query whose selected cells differ between the two routes:
    there the routes took other cells, so they compute other functions.
    A query's cells may differ only at a ranking near-tie, its sorted
    dists agreeing to TOL between the routes (required). ours, ref: the
    routes' (dists, offsets). Returns (mask of `shape`, the number of
    such queries)."""
    import torch.nn.functional as F_
    (d_o, i_o), (d_r, i_r) = ours, ref
    swap = (i_o != i_r).any(-1).any(-1)                   # [B,HD,T,nH,nW]
    s_o, s_r = d_o.sort(-1).values, d_r.sort(-1).values
    agree = ((s_o == s_r) | ((s_o - s_r).abs() <= TOL * (1 + s_r.abs()))) \
        .all(-1)
    require(bool(agree[swap].all()), "a query's cells differ between the "
            "routes away from a near-tie of its dists")
    off = max(float(i[..., 1:].abs().max()) for i in (i_o, i_r))
    R = ps // 2 if output else ps // 2 + 1 + int(np.ceil(off))
    wt = 0 if output else wt
    m = F_.max_pool3d(swap.any(1)[:, None].float(),
                      (2 * wt + 1, 2 * R + 1, 2 * R + 1), stride=1,
                      padding=(wt, R, R)) > 0           # [B,1,T,H,W]
    return m[:, 0, :, None].expand(shape), int(swap.sum())


def compare(torch, g, ref, what, searches, *, wt, ps):
    """g against ref within TOL * max|ref|. Where it misses: for a
    video-shaped g, the elements in reach of a query whose cells differ
    between the routes at a near-tie are left out (flipped_reach,
    counted); then the largest remaining error is held to NEAR_TIE_TOL *
    max|ref| if it lies at a near-tie of the search (near_tie).
    `searches()` returns the two routes' (dists, offsets). Returns
    (max|g - ref| compared, max|ref|)."""
    require(bool(g.isfinite().all()), f"{what}: non-finite")
    scale = float(ref.abs().max())
    diff = (g - ref).abs()
    err = float(diff.max()) if g.numel() else 0.
    if err <= TOL * scale:
        return err, scale
    if g.ndim == 5:
        mask, n_flip = flipped_reach(torch, tuple(g.shape), *searches(),
                                     wt=wt, ps=ps)
        if n_flip:
            diff = diff.masked_fill(mask, 0.)
            log(f"[train] {what}: max|err| {err:.3e} = {err / scale:.3e} * "
                f"max|ref|; {n_flip} queries took other cells at a "
                f"near-tie, {float(mask.float().mean()):.4%} of the "
                f"elements lie in their reach and are left out")
            err = float(diff.max())
            if err <= TOL * scale:
                return err, scale
    idx = tuple(int(x) for x in np.unravel_index(int(diff.argmax()),
                                                 tuple(diff.shape)))
    ok, cause = near_tie(torch, idx, tuple(g.shape), *searches(), wt=wt,
                         ps=ps)
    log(f"[train] {what}: max|err| {err:.3e} = {err / scale:.3e} * max|ref| "
        f"> {TOL} * max|ref| at element {idx} ({float(g[idx]):.6e} against "
        f"{float(ref[idx]):.6e}); {cause}")
    require(ok, f"{what}: max|err| {err:.3e} > {TOL} * max|ref| = "
            f"{TOL * scale:.3e}, not at a near-tie")
    require(err <= NEAR_TIE_TOL * scale, f"{what}: max|err| {err:.3e} > "
            f"{NEAR_TIE_TOL} * max|ref| at a near-tie")
    log(f"[train] {what}: held to {NEAR_TIE_TOL} * max|ref| at that "
        "near-tie")
    return err, scale


def check_routes(torch, label, run, kernels, attn, step, data, geo):
    """A training path `run()` -> (grads, updates, trained model, losses)
    through the kernels (each of `kernels` launched, no plain backward
    called), through the plain backwards on the kernels' forward and
    through the plain route. Gradients and each parameter's SGD update
    are compared at TOL * max|ref| (NEAR_TIE_TOL at a printed near-tie,
    against routes with another forward). `attn` is the NonLocalAttention
    the path starts from. Returns the kernel route's launch counts."""
    reset_counts()
    grads, updates, model, losses = run()
    torch.cuda.synchronize()
    launches, plain_calls = read_counts()
    log(f"[{label}] launches on the kernel route: {launches}; plain "
        f"backward calls: {plain_calls}")
    require(all(launches[k] > 0 for k in kernels),
            f"a kernel of the {label} path was never launched")
    require(not any(plain_calls.values()),
            "a plain backward ran on the kernel route")
    # the same forward with the plain backwards: the backwards in situ
    with plain_route(forward=False):
        bwd_grads, bwd_updates, bwd_model, _ = run()
    with plain_route():
        ref_grads, ref_updates, ref_model, ref_losses = run()

    def searches(what, mine, theirs, plain):
        """The search of `what` with this route's model `mine` and with
        the reference's `theirs` on its route, computed once if asked."""
        memo = []

        def go():
            if not memo:
                memo.append(route_search(torch, what, mine, step, data))
                with plain_route() if plain else contextlib.nullcontext():
                    memo.append(route_search(torch, what, theirs, step,
                                             data))
            return memo
        return go

    for what, gs in grads.items():
        plain_search = searches(what, attn, attn, True)
        for name, g in gs.items():
            # same forward: no near-tie can arise, TOL holds
            err_b, _ = grad_close(g, bwd_grads[what][name],
                                  f"{what} grad {name} vs the plain "
                                  "backwards on the kernels' forward")
            err, scale = compare(torch, g, ref_grads[what][name],
                                 f"{what} grad {name} vs the plain route",
                                 plain_search, **geo)
            log(f"[{label}] {what} grad {name}: max|g| {scale:.3e}, "
                f"max|kernels-plain| {err:.3e}, max|kernels-plain "
                f"backwards| {err_b:.3e}")
    require(float(grads["NonLocalAttention"]["fflow"].abs().max()) > 0,
            "NonLocalAttention flow gradient vanished")
    log(f"[{label}] SGD losses, kernels {losses}, plain {ref_losses}")
    require(losses[-1] < losses[0], "SGD did not lower the loss")
    # each parameter's change over the steps, against its change on the
    # other routes: the tolerance scales with the change itself
    for name, u in updates.items():
        err, scale = compare(
            torch, u, ref_updates[name], f"SGD update of {name} vs the "
            "plain route", searches("NonLocalAttention", model, ref_model,
                                    True), **geo)
        err_b, _ = compare(
            torch, u, bwd_updates[name], f"SGD update of {name} vs the "
            "plain backwards", searches("NonLocalAttention", model,
                                        bwd_model, False), **geo)
        require(scale > 0, f"SGD left {name} unchanged")
        log(f"[{label}] {SGD_STEPS} SGD steps, update of {name}: "
            f"max|update| {scale:.3e}, max|kernels-plain| {err:.3e}, "
            f"max|kernels-plain backwards| {err_b:.3e}")
    return launches

def agg_inputs(torch, dev, *, B=1, HD=2, T=3, F=8, H=64, K=8, stride=2):
    """The second config of the aggregation checks: a seeded video,
    weights with negative ones and ones below 1e-8, and offsets with exact
    half-integers (rounded half to even) and -1e8 fills."""
    rng = np.random.default_rng(SEED + 5)
    n = (H - 1) // stride + 1
    weights = rng.random((B, HD, T, n, n, K))
    weights[..., 0], weights[..., 1] = -0.25, 5e-9
    flows = np.stack([rng.integers(-1, 2, (B, HD, T, n, n, K)),
                      4 * rng.standard_normal((B, HD, T, n, n, K)),
                      4 * rng.standard_normal((B, HD, T, n, n, K))], -1)
    flows[..., 2, 1:] = (0.5, -1.5)
    flows[..., 3, 1:] = (1.5, -0.5)
    flows[:, :, :, ::5, ::3, 7, :] = -1e8
    return tuple(torch.from_numpy(np.asarray(x, np.float32)).to(dev) for x in
                 (rng.standard_normal((B, HD, T, F, H, H)), weights, flows))


def agg_terms(torch, plain, vid, live, flows, cfg):
    """The (query, slot, frame step, tap) terms a ScatterAdd or Pool
    computes on this run's data: its plain version on a one-channel video
    of ones, with weight 1 where `live` and 0 elsewhere (the pool divides
    by a count of 1 where it writes)."""
    with torch.no_grad():
        ones = torch.ones_like(vid[:, :, :, :1])
        return float(plain(ones, live.float(), flows, **cfg).double().sum())


def agg_kernel_phase(torch, dev, name, inputs, scfg, pcfg):
    """B7-B10 against their plain versions on (vid, weights, offsets) at
    one config (scfg, pcfg: every keyword of the ScatterAdd and the Pool
    wrapper but the output size, which the backward's config gets from
    the output): outputs at atol = rtol = TOL, gradients on a seeded
    cotangent at TOL * max|ref|, each non-zero, and the offsets' gradients
    exactly 0. Returns the largest errors, the bounds from this run's data
    and the arguments of the timings."""
    from stnls_tpu_torch.ops import agg_sp_cuda as sp
    vid, weights, flows = inputs
    rng = np.random.default_rng(SEED + 6)
    F = vid.shape[3]

    def nb(*xs):
        return sum(x.numel() * x.element_size() for x in xs)

    errs, bounds, args = {}, {}, {}
    for kf, kb, fwd, plain, bwd, plain_bwd, cfg, live in (
            ("B7", "B8", sp.nl_scatter_add, sp.nl_scatter_add_plain,
             sp.nl_scatter_add_bwd, sp._scatter_add_bwd_plain, scfg,
             weights != 0),
            ("B9", "B10", sp.nl_pool, sp.nl_pool_plain, sp.nl_pool_bwd,
             sp._pool_bwd_plain, pcfg, weights >= 1e-8)):
        with torch.no_grad():
            out = fwd(vid, weights, flows, **cfg)
            torch.cuda.synchronize()
            ref = plain(vid, weights, flows, **cfg)
        require(float(ref.abs().max()) > 0, f"{kf} {name}: the output is 0")
        errs[kf] = close(out, ref, f"{kf} {name} out vs plain")
        terms = agg_terms(torch, plain, vid, live, flows, cfg)
        log(f"[agg] {kf} {name}: out {tuple(out.shape)}, max|kernel-plain| "
            f"{errs[kf]:.3e}; {terms:.0f} (query, slot, step, tap) terms "
            "with a live weight")
        g = torch.from_numpy(rng.standard_normal(tuple(out.shape))
                             .astype(np.float32)).to(dev)
        bcfg = dict(cfg, outH=out.shape[-2], outW=out.shape[-1]) \
            if kf == "B7" else cfg
        b_args = (vid, weights, flows, g, bcfg, (True, True, True))
        g_k = bwd(*b_args)
        torch.cuda.synchronize()
        g_p = plain_bwd(*b_args)
        errs[kb] = 0.
        for gk, gp, what in zip(g_k, g_p, ("g_vid", "g_weights")):
            err, scale = grad_close(gk, gp, f"{kb} {name} {what}")
            require(scale > 0, f"{kb} {name} {what}: the gradient is 0")
            errs[kb] = max(errs[kb], err)
            log(f"[agg] {kb} {name} {what}: max|g| {scale:.3e}, "
                f"max|kernel-plain| {err:.3e}")
        require(not g_k[2].any() and not g_p[2].any(),
                f"{kb} {name}: the offsets' gradient is not 0")
        in_bytes = nb(vid, weights, flows)
        if kf == "B7":
            in_frame = agg_terms(torch, plain, vid, torch.ones_like(live),
                                 flows, cfg)
            bounds["B7"] = bound_ms(in_bytes + nb(out),
                                    terms * F * FLOPS_PER_TAP["B7"])
            bounds["B8"] = bound_ms(in_bytes + nb(g, *g_k[:2]),
                                    (terms + in_frame) * F
                                    * FLOPS_PER_TAP["B8"])
        else:
            bounds["B9"] = bound_ms(in_bytes + nb(out), terms * F
                                    * FLOPS_PER_TAP["B9"] + out.numel())
            bounds["B10"] = bound_ms(in_bytes + nb(g, *g_k[:2]), terms * F
                                     * FLOPS_PER_TAP["B10"] + g.numel())
        args[kf], args[kb] = (inputs, cfg), b_args
    return dict(err=errs, bounds=bounds, args=args)


def agg_example_phase(torch, dev):
    """The agg example's twin at full width through the kernels (launch
    counts; no plain backward), then its four aggregators through the
    plain route on the same search outputs: outputs at TOL, gradients to
    the video and the weights at TOL * max|ref| and non-zero, the offsets'
    gradients exactly 0 for ScatterAdd and Pool and compared (non-zero)
    for Gather and GatherAdd. Its search is held against the plain
    route's. Returns the launch counts and the twin's arguments."""
    from stnls_tpu_torch import agg_example
    cfg = agg_example.CONFIG
    inputs = agg_example.make_inputs(SEED, device=dev, **cfg)
    reset_counts()
    weights, offsets, v6, res = agg_example.run(*inputs, cfg)
    torch.cuda.synchronize()
    launches, plain_calls = read_counts()
    log(f"[agg example] launches: {launches}; plain backward calls: "
        f"{plain_calls}")
    require(all(launches[k] > 0 for k in (
        "nls_topk_fwd", "agg_gather_fwd", "agg_gather_bwd",
        "agg_scatter_add_fwd", "agg_scatter_add_bwd", "agg_pool_fwd",
        "agg_pool_bwd")), "a kernel of the agg example was never launched")
    require(not any(plain_calls.values()),
            "a plain backward ran on the kernel route")
    with plain_route():
        ref = agg_example.aggregate(v6, weights, offsets, **cfg)
    B, T, C, H, W = inputs[0].shape
    HD, K, ps = cfg["HD"], cfg["K"], cfg["ps"]
    shapes = {"gather": (B, HD, K, T, C // HD, H, W),
              "gather_add": (B, HD, T, C // HD, H, W),
              "scatter_add": (B, HD, T, C // HD, H, W),
              "pool": (B, HD, T, C // HD, ps * H, ps * W)}
    for name, (out, *grads) in res.items():
        r_out, *r_grads = ref[name]
        require(tuple(out.shape) == shapes[name] and
                bool(out.isfinite().all()),
                f"agg example {name}: shape {tuple(out.shape)} or non-finite")
        err = close(out, r_out, f"agg example {name} kernels vs plain")
        msg = [f"out {tuple(out.shape)} max|kernels-plain| {err:.3e}"]
        pairs = list(zip(grads[:2], r_grads[:2], ("g_vid", "g_weights")))
        if name in ("scatter_add", "pool"):
            require(not grads[2].any() and not r_grads[2].any(),
                    f"agg example {name}: the offsets' gradient is not 0")
            msg.append("g_offsets 0 on both routes")
        else:
            # all of them: off the self slot's integer offsets the
            # softmax(-10 d) weights underflow to 0, and so do the
            # offsets' gradients
            pairs.append((grads[2], r_grads[2], "g_offsets"))
        for g, r, what in pairs:
            err, scale = grad_close(g, r, f"agg example {name} {what}")
            require(scale > 0, f"agg example {name} {what}: the gradient "
                    "is 0")
            msg.append(f"{what} max|g| {scale:.3e} max|kernels-plain| "
                       f"{err:.3e}")
        log(f"[agg example] {name}: " + "; ".join(msg))
    d_k, o_k = agg_example.search(*inputs, **cfg)
    with plain_route():
        d_p, o_p = agg_example.search(*inputs, **cfg)
    err = close(d_k, d_p, "agg example search dists kernels vs plain")
    share = float((o_k != o_p).any(-1).float().mean())
    log(f"[agg example] search: max|dists-plain| {err:.3e}; slots whose "
        f"offsets differ {share:.4%}")
    return dict(launches=launches, inputs=inputs,
                search=(v6.contiguous(), weights, offsets))


# The checks of B1, B5 and B6 at (ps, F a head) beside the slice's, on
# 48^2 frames (B=1, HD=1, T=3, ws=5, wt=1, smooth flows): each of ps 1, 5
# and 7 with each F of 2, 4, 16 and 32, among them dilation 2, use_adj,
# prod, int, stride0 = 2, stride1 = 0.5, no anchor, and an anchored K = 65
# (64 ranked slots, the most B1 keeps). B6's cotangent: the per-frame
# top-2 of anchor_each for l2 ("each"), every cell for prod ("dense").
PS_CASES = (
    dict(ps=1, F=2, k=10),
    dict(ps=1, F=4, k=10, itype="int", dilation=2),
    dict(ps=1, F=16, k=65, dist_type="prod", stride0=2),
    dict(ps=1, F=32, k=10, anchor=False, use_adj=True),
    dict(ps=5, F=2, k=10, dilation=2, use_adj=True),
    dict(ps=5, F=4, k=10, dist_type="prod"),
    dict(ps=5, F=16, k=65, itype="int", stride0=2),
    dict(ps=5, F=32, k=10, stride1=0.5),
    dict(ps=7, F=2, k=10, dilation=2),
    dict(ps=7, F=4, k=10, itype="int", dist_type="prod", use_adj=True),
    dict(ps=7, F=16, k=10, stride0=2, use_adj=True, stride1=0.5),
    dict(ps=7, F=32, k=65, stride0=2),
)
PS_DEFAULTS = dict(ws=5, wt=1, stride0=1, stride1=1, anchor=True,
                   dist_type="l2", dilation=1, use_adj=False, itype="float")


def search_kernel_case(torch, dev, vid0, vid1, flows, c, label):
    """B1 and B5 against their plain versions, bitwise, and B6 at
    TOL * max|ref| (centre gradients off the integer lattice, 0 on the int
    path), at one configuration c (PS_DEFAULTS' keys, ps, k). Returns B6's
    largest error, and the arguments and cotangent kind of B5 and B6."""
    from stnls_tpu_torch.ops import nls_cuda, nls_vol_cuda
    from stnls_tpu_torch.ops.nls import search_centres
    from stnls_tpu_torch.ops.nls_k import search_aux, aux_to_inds3
    rng = np.random.default_rng(SEED + 7)
    kw = {key: c[key] for key in ("ws", "wt", "ps", "stride0", "stride1",
                                  "dist_type", "dilation", "use_adj",
                                  "itype")}
    with torch.no_grad():
        d_k, c_k = nls_cuda.nls_topk(vid0, vid1, flows, k=c["k"],
                                     anchor=c["anchor"], **kw)
        torch.cuda.synchronize()
        d_p, c_p = nls_cuda.nls_topk_plain(vid0, vid1, flows, k=c["k"],
                                           anchor=c["anchor"], **kw)
    require(torch.equal(d_k, d_p), f"B1 {label}: dists differ from the "
            f"plain version's (max {float((d_k - d_p).abs().max()):.3e})")
    require(torch.equal(c_k, c_p), f"B1 {label}: cells differ")
    ctr_h, ctr_w = (x.contiguous() for x in search_centres(
        vid0.shape, flows, wt=c["wt"], stride0=c["stride0"],
        itype=c["itype"]))
    with torch.no_grad():
        d = nls_vol_cuda.nls_volume(vid0, vid1, ctr_h, ctr_w, **kw)
        torch.cuda.synchronize()
        d_vp = nls_vol_cuda.nls_volume_plain(vid0, vid1, ctr_h, ctr_w, **kw)
    require(torch.equal(d, d_vp), f"B5 {label}: volume differs from the "
            "plain version's")
    aux = search_aux(vid0.shape, flows, ws=c["ws"], wt=c["wt"],
                     stride0=c["stride0"], stride1=c["stride1"],
                     itype=c["itype"])
    kind = "each" if c["dist_type"] == "l2" else "dense"
    g_d = volume_cotangent(torch, rng, d, aux_to_inds3(aux, d.shape), kind,
                           c["wt"])
    args = (vid0, vid1, ctr_h, ctr_w, g_d, dict(kw, full_ws=True))
    g_k = nls_vol_cuda.nls_volume_bwd(*args)
    torch.cuda.synchronize()
    g_p = nls_vol_cuda.nls_volume_bwd_plain(*args)
    off = (off_integer(aux["dh"]).all(4), off_integer(aux["dw"]).all(4))
    err6 = 0.
    for gk, gp, what, mask in zip(g_k, g_p, ("g_vid0", "g_vid1", "g_ctr_h",
                                             "g_ctr_w"), (None, None) + off):
        if mask is not None and c["itype"] == "int":
            require(not gk.any() and not gp.any(),
                    f"B6 {label}: int-path {what} not 0")
            continue
        if mask is not None:
            gk, gp = gk[mask], gp[mask]
        if gp.numel() == 0:
            continue    # no lattice off the integers (no flows, stride1 1)
        err, scale = grad_close(gk, gp, f"B6 {label} {kind} {what}")
        require(scale > 0, f"B6 {label} {what}: the gradient is 0")
        err6 = max(err6, err)
    active = int(((g_d != 0) & d.isfinite()).sum())
    log(f"[ps kernels] {label}: B1 dists and cells and B5 volume equal to "
        f"the plain versions bitwise (K = {d_k.shape[-1]}, "
        f"{int(d.isinf().sum())} of {d.numel()} cells outside the frame); "
        f"B6 ({kind}, {active} cells with a cotangent) max|kernel-plain| "
        f"{err6:.3e}, centre gradients compared at {int(off[0].sum())} (h) "
        f"and {int(off[1].sum())} (w) of {off[0].numel()} (query, slot)")
    return dict(err6=err6, b5_args=(vid0, vid1, ctr_h, ctr_w), kw=kw,
                b6_args=args, active=active, d=d)


def ps_kernel_phase(torch, dev):
    """B1, B5 and B6 at PS_CASES, then a K = 100 search (99 ranked slots)
    through NonLocalSearch: it runs on the volume route (B5, no B1) and
    gives the plain B1's top-100. Returns B6's largest error."""
    from stnls_tpu_torch.ops import nls_cuda
    from stnls_tpu_torch.search import NonLocalSearch
    rng = np.random.default_rng(SEED + 8)
    err6 = 0.
    for case in PS_CASES:
        c = dict(PS_DEFAULTS, **case)
        shape = dict(B=1, HD=1, T=3, F=c["F"], H=48, W=48, wt=c["wt"],
                     stride0=c["stride0"])
        label = f"(ps, F) = ({c['ps']}, {c['F']}) " + ", ".join(
            f"{key}={c[key]}" for key in ("k", "anchor", "itype", "dist_type",
                                          "dilation", "use_adj", "stride0",
                                          "stride1")
            if c[key] != PS_DEFAULTS.get(key, c[key]) or key == "k")
        r = search_kernel_case(torch, dev, *make_inputs(torch, rng, dev,
                                                          **shape), c, label)
        err6 = max(err6, r["err6"])
    vid0, vid1, flows = make_inputs(torch, rng, dev, B=1, HD=1, T=3, F=2,
                                      H=48, W=48, wt=1)
    search = NonLocalSearch(9, 1, 1, 100, self_action="anchor")
    reset_counts()
    with torch.no_grad():
        d, _ = search(vid0, vid1, flows)
    torch.cuda.synchronize()
    launches = read_counts()[0]
    require(launches["nls_vol_fwd"] > 0 and launches["nls_topk_fwd"] == 0,
            f"K = 100 did not take the volume route: {launches}")
    with torch.no_grad():
        d_p, _ = nls_cuda.nls_topk_plain(vid0, vid1, flows, ws=9, wt=1, ps=1,
                                         stride0=1, stride1=1, k=100,
                                         anchor=True)
    err = close(d, d_p, "K = 100 search vs the plain B1")
    log(f"[ps kernels] K = 100 (99 ranked slots): volume route, launches "
        f"nls_vol_fwd {launches['nls_vol_fwd']}, nls_topk_fwd "
        f"{launches['nls_topk_fwd']}; dists {tuple(d.shape)} "
        f"max|search-plain B1| {err:.3e}")
    return err6


@contextlib.contextmanager
def run_time_body():
    """B1 and B5 take their run-time body for every (ps, F) inside."""
    from stnls_tpu_torch.ops import nls_cuda, nls_vol_cuda
    nls_cuda.COMPILED_BODY = nls_vol_cuda.COMPILED_BODY = False
    try:
        yield
    finally:
        nls_cuda.COMPILED_BODY = nls_vol_cuda.COMPILED_BODY = True


def compiled_vs_run_time(torch, dev, smi_line, res, vres):
    """At the slice config, (ps, F a head) = (3, 8) (its kernel checks'
    inputs) and (3, 16) (the same shape with one head of 16): each body
    with ps and F compiled in (the pairs B1's and B5's sources list) against
    the run-time body, first for bitwise equal outputs, then timed in turns
    (compiled, run-time, run-time, compiled). Returns {pair: {kernel:
    (compiled ms, run-time ms)}}."""
    from stnls_tpu_torch.attn_step import cuda_ms
    from stnls_tpu_torch.ops import cuda_lib, nls_cuda, nls_vol_cuda
    from stnls_tpu_torch.ops.nls import search_centres
    lib = cuda_lib.load()
    kw, vkw = res["kw"], vres["b5_kw"]
    rng = np.random.default_rng(SEED + 9)
    u0, u1, uflows = make_inputs(torch, rng, dev, B=1, HD=1, T=5, F=16,
                                 H=128, W=128, wt=2)
    uc = tuple(x.contiguous() for x in search_centres(
        u0.shape, uflows, wt=2, stride0=1))
    cases = {(3, 8): (res["inputs"][:3], vres["b5_args"]),
             (3, 16): ((u0, u1, uflows), (u0, u1) + uc)}
    out = {}
    for pair, (b1_args, b5_args) in cases.items():
        calls = {}      # each returns a tuple of tensors
        if lib.stnls_nls_topk_compiled(*pair):
            calls["B1"] = lambda: nls_cuda.nls_topk(*b1_args, **kw)
        if lib.stnls_nls_vol_compiled(*pair):
            calls["B5"] = lambda: (nls_vol_cuda.nls_volume(*b5_args,
                                                           **vkw),)
        times = {}
        with torch.no_grad():
            for key, fn in calls.items():
                compiled = fn()
                with run_time_body():
                    run = fn()
                require(all(torch.equal(x, y) for x, y in zip(compiled,
                                                              run)),
                        f"{key} {pair}: the run-time body differs from the "
                        "compiled one")
                t = [cuda_ms(fn)]
                with run_time_body():
                    t += [cuda_ms(fn), cuda_ms(fn)]
                t.append(cuda_ms(fn))
                times[key] = ((t[0] + t[3]) / 2, (t[1] + t[2]) / 2)
        out[f"{pair[0]},{pair[1]}"] = times
        log(f"[times] {smi_line}: (ps, F) = {pair}, compiled / run-time body "
            "(outputs bitwise equal): " + "; ".join(
                f"{key} {a:.3f} / {b:.3f} ms" for key, (a, b) in
                times.items()))
    return out


def crop_inputs(inputs, H, W):
    """The top-left H x W of each [B,T,C,H,W] input."""
    return tuple(x[..., :H, :W].contiguous() for x in inputs)


# configs 5 and 7 hold their plain route to this crop of the frames (the
# plain exhaustive volume at 1080p would take 29 GB before its
# intermediates); configs 1 and 4 run it at full size, config 4 falling
# back to the crop should the card run out of memory
MATRIX_CROP = (270, 480)


def matrix_phase(torch, dev):
    """benchmarks/matrix.py configs 1, 4, 5 and 7 at their published sizes
    through the kernels (stnls_tpu_torch.matrix_steps): shapes, finite
    values, the launch counts (B1, with B2 for a backward, B3/B4 for config
    1; no volume kernel, no plain backward) and peak memory; q = k, so the
    anchored slot 0 holds dist 0 exactly and slots 1.. ascend. Then the
    plain route (plain_route) on the same inputs, or on MATRIX_CROP of them
    for 5 and 7: dists, offsets and the loss at TOL, the video gradient
    under compare()'s rules. Returns {name: (step, inputs, launches,
    peak GB)}."""
    from stnls_tpu_torch import matrix_steps as ms
    out = {}
    for name in ms.CONFIGS:
        cfg = ms.config(name)
        step = ms.make_step(name)
        inputs = ms.make_inputs(name, SEED, device=dev)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        reset_counts()
        res = step(*inputs)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated(dev) - base) / 1e9
        launches, plain_calls = read_counts()
        B, T, F, H, W = inputs[0].shape
        d = res["dists"]
        require(tuple(d.shape) == (B, cfg["HD"], T, H, W, cfg["K"]) and
                tuple(res["inds"].shape) == tuple(d.shape) + (3,),
                f"matrix {name}: shapes {tuple(d.shape)}")
        require(all(bool(x.isfinite().all()) for x in res.values()),
                f"matrix {name}: non-finite output")
        wanted = ["nls_topk_fwd"] + (["nls_topk_bwd"] if cfg["backward"]
                                     else [])
        if cfg["config"] == 1:
            wanted += ["agg_gather_fwd", "agg_gather_bwd"]
        require(all(launches[k] > 0 for k in wanted) and
                launches["nls_vol_fwd"] == 0,
                f"matrix {name}: launches {launches}")
        require(not any(plain_calls.values()),
                f"matrix {name}: a plain backward ran on the kernel route")
        require(not d[..., 0].any(), f"matrix {name}: slot 0 is not 0")
        require(bool((d[..., 2:] >= d[..., 1:-1]).all()),
                f"matrix {name}: slots 1.. do not ascend")
        if cfg["backward"]:
            require(float(res["g_vid"].abs().max()) > 0,
                    f"matrix {name}: the video gradient is 0")
        log(f"[matrix] {name} (config {cfg['config']}, "
            f"{'fwd+bwd' if cfg['backward'] else 'fwd'}): dists "
            f"{tuple(d.shape)}, launches {launches}, peak {peak:.3f} GB")
        crops = [None, MATRIX_CROP] if cfg["config"] in (1, 4) \
            else [MATRIX_CROP]
        for crop in crops:
            p_in = inputs if crop is None else crop_inputs(inputs, *crop)
            try:
                with plain_route():
                    ref = step(*p_in)
            except torch.cuda.OutOfMemoryError:
                torch.cuda.empty_cache()
                log(f"[matrix] {name}: the plain route ran out of memory at "
                    f"{tuple(p_in[0].shape[-2:])}; holding it to the crop")
                continue
            mine = res if crop is None else step(*p_in)
            break
        compare_matrix(torch, name, cfg, mine, ref,
                       tuple(p_in[0].shape[-2:]))
        out[name] = (step, inputs, launches, peak)
        del res, mine, ref
    return out


def compare_matrix(torch, name, cfg, mine, ref, size):
    """One matrix config's kernel route against its plain route: dists and
    the loss at TOL, offsets at TOL where a query's cells agree (they may
    differ only at a near-tie: flipped_reach requires it), the video
    gradient by compare()."""
    err = close(mine["dists"], ref["dists"], f"matrix {name} dists")
    searches = ((mine["dists"], mine["inds"]), (ref["dists"], ref["inds"]))
    swap = (mine["inds"] != ref["inds"]).any(-1).any(-1)
    if bool(swap.any()):
        flipped_reach(torch, tuple(mine["inds"].shape[:1]) + (
            cfg["T"], 1) + size, *searches, wt=cfg["wt"], ps=cfg["ps"])
    close(mine["inds"][~swap], ref["inds"][~swap], f"matrix {name} offsets")
    msg = (f"dists max|kernels-plain| {err:.3e}, {int(swap.sum())} queries "
           "took other cells at a near-tie")
    if cfg["backward"]:
        close(mine["loss"], ref["loss"], f"matrix {name} loss")
        g_err, scale = compare(torch, mine["g_vid"], ref["g_vid"],
                               f"matrix {name} g_vid", lambda: searches,
                               wt=cfg["wt"], ps=cfg["ps"])
        msg += f"; g_vid max|g| {scale:.3e}, max|kernels-plain| {g_err:.3e}"
    log(f"[matrix] {name} vs the plain route at {size[0]}x{size[1]}: {msg}")


def matrix_search_args(torch, cfg, inputs):
    """A matrix config's inputs as its search's kernels take them: the
    video split into heads [B,HD,T,F,H,W] and the window flows
    [B,1,T,W_t-1,2,H,W] (none for config 4, which has no flows)."""
    from stnls_tpu_torch.nn.flow import search_flow
    from stnls_tpu_torch.search.utils import shape_vids
    v = shape_vids(cfg["HD"], [inputs[0]])[0].contiguous()
    fl = search_flow(inputs[1], inputs[2], cfg["wt"], 1) \
        if len(inputs) == 3 else torch.zeros(
            (1, cfg["T"], 0, 2) + tuple(v.shape[-2:]), device=v.device)
    return v, fl[:, None].contiguous()


# config 7's whole 1080p frames are held head by head: B1 against its plain
# version over bands of this many query rows (the plain volume of one whole
# head would take 14.5 GB before its intermediates), B2 against its plain
# version over chunks of this many query frames
FULL_BAND_ROWS, FULL_CHUNK_FRAMES = 90, 2


def full_frame_phase(torch, name, inputs, rows=FULL_BAND_ROWS,
                     frames=FULL_CHUNK_FRAMES):
    """A matrix config at its full frames, where its plain route does not
    fit, one head at a time. B1's dists and cells against the plain
    selection (search._pallas_topk_aux) of the plain volume
    (ops/nls.lattice_search), computed for each band of `rows` query rows
    against the whole frames: bitwise. B2 at B1's cells on a seeded
    cotangent against its plain version, run over chunks of `frames` query
    frames (each against all key frames, g_vid1 summed over the chunks):
    1e-4 * max|ref|, position gradients off the integer lattice. A float
    search (configs 5 and 7). Returns B2's largest error."""
    from stnls_tpu_torch import matrix_steps as ms
    from stnls_tpu_torch.ops import nls_cuda
    from stnls_tpu_torch.ops.geometry import time_window_frames
    from stnls_tpu_torch.ops.nls import lattice_search
    from stnls_tpu_torch.ops.nls_k import cells_geometry, search_aux
    from stnls_tpu_torch.search.non_local_search import _pallas_topk_aux
    cfg = ms.config(name)
    require(cfg["itype"] == "float", f"{name}: a float search expected")
    ws, wt, ps, K = cfg["ws"], cfg["wt"], cfg["ps"], cfg["K"]
    v_all, fl = matrix_search_args(torch, cfg, inputs)
    B, HD, T, F, H, W = v_all.shape
    dev = v_all.device
    b1 = dict(ws=ws, wt=wt, ps=ps, stride0=1, stride1=1, k=K, anchor=True)
    bwd_cfg = dict(ps=ps, stride0=1, dist_type="l2", dilation=1,
                   use_adj=False, itype="float")
    tj = torch.as_tensor(time_window_frames(T, wt), device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    err2, n_off = 0., 0
    for h in range(HD):
        v = v_all[:, h:h + 1].contiguous()
        with torch.no_grad():
            d_k, c_k = nls_cuda.nls_topk(v, v, fl, **b1)
            aux = search_aux(v.shape, fl, ws=ws, wt=wt, stride0=1, stride1=1)
            for r0 in range(0, H, rows):
                band = slice(r0, min(r0 + rows, H))
                vol = lattice_search(
                    v, v, tj[None, None, :, :, None, None],
                    aux["ctr_h"][..., band, :], aux["ctr_w"][..., band, :],
                    ws=ws, stride1=1., ref_h=torch.arange(H, device=dev)[band],
                    ref_w=torch.arange(W, device=dev), dist_type="l2", ps=ps,
                    patch_offset=-(ps // 2))
                d_p, c_p = _pallas_topk_aux(
                    vol, dict(dt_tab=aux["dt_tab"], dh=aux["dh"][..., band, :],
                              dw=aux["dw"][..., band, :]),
                    self_action="anchor", k=K, dist_type="l2")
                require(torch.equal(d_k[..., band, :, :], d_p) and
                        torch.equal(c_k[..., band, :, :], c_p.int()),
                        f"B1 {name} head {h}: query rows {band.start}.."
                        f"{band.stop - 1} differ from the plain volume's")
                del vol, d_p, c_p
            del aux
        geo = cells_geometry(fl, c_k, H=H, W=W, ws=ws, wt=wt, stride0=1,
                             stride1=1)
        pos = (geo["prop_h"], geo["prop_w"], geo["tj_k"], geo["valid"])
        g_d = torch.randn(d_k.shape, generator=gen, device=dev)
        g_k = nls_cuda.nls_topk_bwd(v, v, *pos, g_d, bwd_cfg)
        g_p = [torch.zeros_like(v), torch.zeros_like(v),
               torch.empty_like(pos[0]), torch.empty_like(pos[1])]
        for t0 in range(0, T, frames):
            ts = slice(t0, min(t0 + frames, T))
            part = nls_cuda.nls_topk_bwd_plain(
                v[:, :, ts], v, *(x[:, :, ts] for x in pos), g_d[:, :, ts],
                bwd_cfg)
            g_p[0][:, :, ts] = part[0]
            g_p[1] += part[1]
            g_p[2][:, :, ts], g_p[3][:, :, ts] = part[2], part[3]
            del part
        off = off_integer(geo["prop_h"]) & off_integer(geo["prop_w"])
        n_off += int(off.sum())
        for gk, gp, what, mask in zip(g_k, g_p, ("g_vid0", "g_vid1",
                                                 "g_prop_h", "g_prop_w"),
                                      (None, None, off, off)):
            if mask is not None:
                gk, gp = gk[mask], gp[mask]
            err2 = max(err2, grad_close(gk, gp, f"B2 {name} head {h} "
                                                f"{what}")[0])
        del d_k, c_k, geo, pos, g_d, g_k, g_p, off
    log(f"[matrix] {name} at the full {H}x{W}, {HD} heads: B1 dists and "
        f"cells equal to the plain volume's bitwise ({rows}-row bands); B2 "
        f"on a seeded cotangent max|kernel-plain| {err2:.3e} (plain over "
        f"{frames}-frame chunks; position gradients compared at {n_off} of "
        f"{B * HD * T * H * W * K} (query, slot))")
    return err2


def ps1_kernel_times(torch, dev, smi_line, matrix):
    """B1, B5 and B6 at (ps, F a head) = (1, 2) on MATRIX_CROP of config
    5's inputs and (1, 16) on that of config 4's, against their plain
    versions, with their bounds from these inputs (B6 on the per-frame
    top-2 cotangent); B1 also at the full size, where its launches in the
    matrix phase ran. Returns {label: {kernel: dict(ms, plain_ms,
    bound_ms, bound_by)}}."""
    from stnls_tpu_torch import matrix_steps as ms
    from stnls_tpu_torch.attn_step import cuda_ms
    from stnls_tpu_torch.ops import nls_cuda, nls_vol_cuda

    def nb(*xs):
        return sum(x.numel() * x.element_size() for x in xs)

    out = {}
    for label, name in (("1,2", "align1080p_fwd"), ("1,16", "gda540p_ws9")):
        cfg = ms.config(name)
        c = dict(PS_DEFAULTS, ws=cfg["ws"], wt=cfg["wt"], ps=1, k=cfg["K"],
                 itype=cfg["itype"])
        full = matrix[name][1]
        v, fl = matrix_search_args(torch, cfg, full)
        b1 = dict({key: c[key] for key in ("ws", "wt", "ps", "stride0",
                                           "stride1", "itype")}, k=c["k"],
                  anchor=True)
        with torch.no_grad():
            t_full = cuda_ms(lambda: nls_cuda.nls_topk(v, v, fl, **b1), n=5,
                             warm=1)
        del v, fl
        v, fl = matrix_search_args(torch, cfg, crop_inputs(full, *MATRIX_CROP))
        r = search_kernel_case(torch, dev, v, v, fl, c, f"({label}) "
                               f"{name} {MATRIX_CROP[0]}x{MATRIX_CROP[1]}")
        F = v.shape[3]
        plain = dict(n=3, warm=1)
        with torch.no_grad():
            d_k, c_k = nls_cuda.nls_topk(v, v, fl, **b1)
            t = {"B1": (cuda_ms(lambda: nls_cuda.nls_topk(v, v, fl, **b1)),
                        cuda_ms(lambda: nls_cuda.nls_topk_plain(
                            v, v, fl, **b1), **plain)),
                 "B5": (cuda_ms(lambda: nls_vol_cuda.nls_volume(
                            *r["b5_args"], **r["kw"])),
                        cuda_ms(lambda: nls_vol_cuda.nls_volume_plain(
                            *r["b5_args"], **r["kw"]), **plain))}
        t["B6"] = (cuda_ms(lambda: nls_vol_cuda.nls_volume_bwd(
                       *r["b6_args"])),
                   cuda_ms(lambda: nls_vol_cuda.nls_volume_bwd_plain(
                       *r["b6_args"]), **plain))
        valid = int(r["d"].isfinite().sum())
        g = nls_vol_cuda.nls_volume_bwd(*r["b6_args"])
        bounds = {
            "B1": bound_ms(nb(v, v, fl, d_k, c_k),
                           r["d"].numel() * F * FLOPS_PER_TAP["B1"]),
            "B5": bound_ms(nb(*r["b5_args"], r["d"]),
                           valid * F * FLOPS_PER_TAP["B5"]),
            "B6": bound_ms(nb(*r["b6_args"][:5], *g),
                           r["active"] * F * FLOPS_PER_TAP["B6"])}
        out[label] = {key: dict(ms=t[key][0], plain_ms=t[key][1],
                                bound_ms=bounds[key][0],
                                bound_by=bounds[key][1]) for key in t}
        out[label]["B1"]["full_size_ms"] = t_full
        log(f"[times] {smi_line}: (ps, F) = ({label}) at "
            f"{MATRIX_CROP[0]}x{MATRIX_CROP[1]} of {name}: " + "; ".join(
                f"{key} {t[key][0]:.3f} ms (plain {t[key][1]:.3f}, bound "
                f"{bounds[key][0]:.4f} by {bounds[key][1]})" for key in t)
            + f"; B1 at {tuple(full[0].shape[-2:])} {t_full:.3f} ms")
        del r, g, d_k, c_k, v, fl
    return out


# 14. time sharding: the temporal-chunk mode of B1, B2, B5 and B6 (B12)
# the slice's search on a sequence of 8 frames cut in chunks of 4 with
# halos of 4 (2 * wt), and config 7's 10 frames in chunks of 5 with 6
CHUNK_SLICE = dict(T=8, T_local=4, halo=4)
CHUNK_CONFIG7 = dict(T_local=5, halo=6)


def halo_chunk(x, t0, T_local, halo):
    """Frames t0 - halo .. t0 + T_local + halo - 1 of a whole sequence x
    [B,HD,T,...], zeros beyond its ends: the padded chunk a rank's search
    runs on, as the ring exchange of a single time shard builds it."""
    T = x.shape[2]
    lo, hi = max(0, t0 - halo), min(T, t0 + T_local + halo)
    out = x.new_zeros(x.shape[:2] + (T_local + 2 * halo,) + x.shape[3:])
    out[:, :, lo - t0 + halo:hi - t0 + halo] = x[:, :, lo:hi]
    return out.contiguous()


def sharded_config7_step(torch, mesh):
    """Config 7's step (matrix_steps' "align1080p_fwd+bwd": the search,
    mean(d^2) and its gradient to the video) with the search through
    parallel.time_sharded_search on a mesh of one rank, whose one time
    shard is the whole sequence: step(*matrix_steps.make_inputs(name))
    -> the dict of matrix_steps.make_step's step."""
    from stnls_tpu_torch import matrix_steps as ms
    from stnls_tpu_torch.parallel import time_sharded_search
    require(mesh.size() == 1, "sharded_config7_step runs on one rank")
    cfg = ms.config("align1080p_fwd+bwd")

    def step(vid, fflow, bflow):
        v = vid.detach().requires_grad_()
        v6, fl = matrix_search_args(torch, cfg, (v, fflow, bflow))
        dists, inds = time_sharded_search(
            v6, v6, fl, mesh, ws=cfg["ws"], wt=cfg["wt"], ps=cfg["ps"],
            k=cfg["K"], self_action="anchor", itype=cfg["itype"])
        loss = dists.pow(2).mean()
        g_vid, = torch.autograd.grad(loss, v)
        return dict(dists=dists.detach(), inds=inds.detach(),
                    loss=loss.detach(), g_vid=g_vid)

    return step


def chunk_kernel_case(torch, dev, v0, v1, flows, c, t0, T_local, halo,
                      label, backward=True):
    """B1 and B5 on the chunk of T_local frames from t0 of the whole
    sequence v0, v1, flows (its halos cut from the sequence, zeros beyond
    its ends) against their plain chunk versions, bitwise; with
    `backward`, B6 on the per-frame top-2 cotangent and B2 at B1's cells
    on a seeded one, at TOL * max|ref| (centre and position gradients off
    the integer lattice, 0 on the int path). c: PS_DEFAULTS' keys, ps, k.
    Returns the errors and the kernels' arguments."""
    from stnls_tpu_torch.ops import nls_cuda, nls_vol_cuda
    from stnls_tpu_torch.ops.nls import search_centres
    from stnls_tpu_torch.ops.nls_k import search_aux, aux_to_inds3, \
        cells_geometry
    rng = np.random.default_rng(SEED + 14 + t0)
    T = v0.shape[2]
    chunk = dict(query_t0=t0, T_global=T)
    v0p, v1p = (halo_chunk(x, t0, T_local, halo) for x in (v0, v1))
    fl = flows[:, :, t0:t0 + T_local].contiguous()
    kw = {key: c[key] for key in ("ws", "wt", "ps", "stride0", "stride1",
                                  "dist_type", "dilation", "use_adj",
                                  "itype")}
    b1 = dict(kw, k=c["k"], anchor=True, **chunk)
    with torch.no_grad():
        d_k, c_k = nls_cuda.nls_topk(v0p, v1p, fl, **b1)
        torch.cuda.synchronize()
        d_p, c_p = nls_cuda.nls_topk_plain(v0p, v1p, fl, **b1)
    require(torch.equal(d_k, d_p) and torch.equal(c_k, c_p),
            f"B1 chunk {label}: dists or cells differ from the plain "
            f"version's (max {float((d_k - d_p).abs().max()):.3e})")
    ctr = tuple(x.contiguous() for x in search_centres(
        v0p.shape, fl, wt=c["wt"], stride0=c["stride0"], itype=c["itype"],
        T_global=T))
    with torch.no_grad():
        d = nls_vol_cuda.nls_volume(v0p, v1p, *ctr, **kw, **chunk)
        torch.cuda.synchronize()
        d_vp = nls_vol_cuda.nls_volume_plain(v0p, v1p, *ctr, **kw, **chunk)
    require(torch.equal(d, d_vp), f"B5 chunk {label}: volume differs from "
            "the plain version's")
    out = dict(b1_args=(v0p, v1p, fl), b1_kw=b1, b5_args=(v0p, v1p) + ctr,
               b5_kw=dict(kw, **chunk), d=d, d_k=d_k, c_k=c_k)
    if not backward:
        return out
    aux = search_aux(v0p.shape, fl, ws=c["ws"], wt=c["wt"],
                     stride0=c["stride0"], stride1=c["stride1"],
                     itype=c["itype"], **chunk)
    g_vol = volume_cotangent(torch, rng, d, aux_to_inds3(aux, d.shape),
                             "each", c["wt"])
    b6 = (v0p, v1p) + ctr + (g_vol, dict(kw, full_ws=True, **chunk))
    off6 = (off_integer(aux["dh"]).all(4), off_integer(aux["dw"]).all(4))
    geo = cells_geometry(fl, c_k, H=v0.shape[-2], W=v0.shape[-1],
                         ws=c["ws"], wt=c["wt"], stride0=c["stride0"],
                         stride1=c["stride1"], itype=c["itype"], halo=halo,
                         **chunk)
    g_d = torch.from_numpy(rng.standard_normal(tuple(d_k.shape))
                           .astype(np.float32)).to(dev)
    b2 = (v0p, v1p, geo["prop_h"], geo["prop_w"], geo["tj_k"],
          geo["valid"], g_d, dict(ps=c["ps"], stride0=c["stride0"],
                                  dist_type=c["dist_type"],
                                  dilation=c["dilation"],
                                  use_adj=c["use_adj"], itype=c["itype"]),
          t0, T)
    off2 = off_integer(geo["prop_h"]) & off_integer(geo["prop_w"])
    errs = {}
    for key, fn, plain, args, off in (
            ("B6", nls_vol_cuda.nls_volume_bwd,
             nls_vol_cuda.nls_volume_bwd_plain, b6, off6),
            ("B2", nls_cuda.nls_topk_bwd, nls_cuda.nls_topk_bwd_plain, b2,
             (off2, off2))):
        g_k = fn(*args)
        torch.cuda.synchronize()
        g_p = plain(*args)
        errs[key] = 0.
        for gk, gp, what, mask in zip(g_k, g_p, ("g_vid0", "g_vid1", "g_h",
                                                 "g_w"), (None, None) + off):
            if mask is not None and c["itype"] == "int":
                require(not gk.any() and not gp.any(),
                        f"{key} chunk {label}: int-path {what} not 0")
                continue
            if mask is not None:
                gk, gp = gk[mask], gp[mask]
            err, scale = grad_close(gk, gp, f"{key} chunk {label} {what}")
            require(scale > 0, f"{key} chunk {label} {what}: the gradient "
                    "is 0")
            errs[key] = max(errs[key], err)
        # the halo frames hold no query: vid0's gradient is 0 there
        require(not g_k[0][:, :, :halo].any() and
                not g_k[0][:, :, halo + T_local:].any(),
                f"{key} chunk {label}: gradient in vid0's halo frames")
    log(f"[chunk] {label}: B1 dists and cells and B5 volume equal to the "
        f"plain chunk versions bitwise; B6 (top-2) max|kernel-plain| "
        f"{errs['B6']:.3e}, B2 {errs['B2']:.3e}")
    out.update(errs=errs, b6_args=b6, b2_args=b2,
               active6=int(((g_vol != 0) & d.isfinite()).sum()),
               active2=int((geo["valid"] & (g_d != 0)).sum()))
    return out


def chunk_kernel_phase(torch, dev, H=128):
    """(a) B1 and B5 in chunk mode against their plain chunk versions,
    bitwise, and B2 and B6 at TOL * max|ref|: at the slice's (ps, F) =
    (3, 8) on 128^2 (CHUNK_SLICE; t0 = 0 and 4; float and int; B1 and B5
    also in their run-time body), then at (1, 2) on MATRIX_CROP of config
    7's inputs (CHUNK_CONFIG7; t0 = 0 and 5). (b) The chunks joined over
    the sequence equal the whole video's B1 and B5 bitwise at the slice
    shape. Returns the largest errors and the slice's float t0 = 4 case
    for the timings."""
    from stnls_tpu_torch import matrix_steps as ms
    from stnls_tpu_torch.ops import nls_cuda, nls_vol_cuda
    from stnls_tpu_torch.ops.nls import search_centres
    rng = np.random.default_rng(SEED + 14)
    T, Tl, halo = CHUNK_SLICE["T"], CHUNK_SLICE["T_local"], \
        CHUNK_SLICE["halo"]
    v0, v1, flows = make_inputs(torch, rng, dev, B=1, HD=2, T=T, F=8,
                                H=H, W=H, wt=2)
    errs = {"B2": 0., "B6": 0.}
    timing = None
    for itype in ("float", "int"):
        c = dict(PS_DEFAULTS, wt=2, ps=3, k=10, itype=itype,
                 stride1=0.5 if itype == "float" else 1)
        for t0 in range(0, T, Tl):
            label = f"(3, 8) {H}^2 {itype} t0={t0}"
            r = chunk_kernel_case(torch, dev, v0, v1, flows, c, t0, Tl,
                                  halo, label)
            with run_time_body():
                chunk_kernel_case(torch, dev, v0, v1, flows, c, t0, Tl,
                                  halo, label + " run-time body",
                                  backward=False)
            for key in errs:
                errs[key] = max(errs[key], r["errs"][key])
            if itype == "float" and t0 == Tl:
                timing = r
    # (b) the chunks joined against the whole video, float
    kw = dict(ws=5, wt=2, ps=3, stride0=1, stride1=0.5)
    ctr = tuple(x.contiguous() for x in search_centres(v0.shape, flows,
                                                       wt=2, stride0=1))
    with torch.no_grad():
        d_all, c_all = nls_cuda.nls_topk(v0, v1, flows, k=10, anchor=True,
                                         **kw)
        vol_all = nls_vol_cuda.nls_volume(v0, v1, *ctr, **kw)
        for t0 in range(0, T, Tl):
            r = chunk_kernel_case(torch, dev, v0, v1, flows,
                                  dict(PS_DEFAULTS, wt=2, ps=3, k=10,
                                       stride1=0.5), t0, Tl, halo,
                                  f"whole t0={t0}", backward=False)
            sl = slice(t0, t0 + Tl)
            require(torch.equal(r["d_k"], d_all[:, :, sl]) and
                    torch.equal(r["c_k"], c_all[:, :, sl]) and
                    torch.equal(r["d"], vol_all[:, :, sl]),
                    f"chunk t0={t0}: B1 or B5 differs from the whole "
                    "video's")
    log(f"[chunk] slice {H}^2: B1 and B5 over {T // Tl} chunks of {Tl} "
        "frames joined equal the whole video's bitwise")
    # (1, 2) on the crop of config 7's inputs
    cfg = ms.config("align1080p_fwd+bwd")
    inputs = crop_inputs(ms.make_inputs("align1080p_fwd+bwd", SEED,
                                        device=dev), *MATRIX_CROP)
    v, fl = matrix_search_args(torch, cfg, inputs)
    c = dict(PS_DEFAULTS, ws=cfg["ws"], wt=cfg["wt"], ps=1, k=cfg["K"])
    Tl7, halo7 = CHUNK_CONFIG7["T_local"], CHUNK_CONFIG7["halo"]
    for t0 in range(0, cfg["T"], Tl7):
        r = chunk_kernel_case(torch, dev, v, v, fl, c, t0, Tl7, halo7,
                              f"(1, 2) {MATRIX_CROP[0]}x{MATRIX_CROP[1]} "
                              f"config 7 t0={t0}")
        for key in errs:
            errs[key] = max(errs[key], r["errs"][key])
    return dict(errs=errs, timing=timing)


def chunk_whole_1080p(torch, matrix):
    """(b) at config 7's whole 1080p frames, head by head: B1 over the
    chunks of CHUNK_CONFIG7, joined, equals B1 on the whole video
    bitwise (dists and cells)."""
    from stnls_tpu_torch import matrix_steps as ms
    from stnls_tpu_torch.ops import nls_cuda
    name = "align1080p_fwd+bwd"
    cfg = ms.config(name)
    v_all, fl = matrix_search_args(torch, cfg, matrix[name][1])
    T, Tl, halo = cfg["T"], CHUNK_CONFIG7["T_local"], CHUNK_CONFIG7["halo"]
    b1 = dict(ws=cfg["ws"], wt=cfg["wt"], ps=cfg["ps"], stride0=1,
              stride1=1, k=cfg["K"], anchor=True)
    with torch.no_grad():
        for h in range(cfg["HD"]):
            v = v_all[:, h:h + 1].contiguous()
            d_all, c_all = nls_cuda.nls_topk(v, v, fl, **b1)
            for t0 in range(0, T, Tl):
                vp = halo_chunk(v, t0, Tl, halo)
                d, c = nls_cuda.nls_topk(vp, vp,
                                         fl[:, :, t0:t0 + Tl].contiguous(),
                                         query_t0=t0, T_global=T, **b1)
                sl = slice(t0, t0 + Tl)
                require(torch.equal(d, d_all[:, :, sl]) and
                        torch.equal(c, c_all[:, :, sl]),
                        f"B1 {name} head {h} chunk t0={t0}: differs from "
                        "the whole video's")
                del vp, d, c
            del d_all, c_all
    log(f"[chunk] {name} at the full {tuple(v_all.shape[-2:])}, "
        f"{cfg['HD']} heads: B1 over {T // Tl} chunks of {Tl} frames "
        f"(halo {halo}) joined equals the whole video's bitwise")


def chunk_frame_bytes(r):
    """(bytes of vid0's query frames, bytes of vid1's frames that some
    query's window reaches) of chunk_kernel_case's chunk r: the frames a
    chunk-mode kernel reads of each video, and writes of its gradient."""
    from stnls_tpu_torch.ops.nls import window_tables
    v0p, _, fl = r["b1_args"]
    kw = r["b1_kw"]
    T_local = fl.shape[2]
    halo = (v0p.shape[2] - T_local) // 2
    tj, _ = window_tables(T_local, kw["wt"], t0=kw["query_t0"],
                          T_global=kw["T_global"], halo=halo)
    frame = v0p[:, :, 0].numel() * v0p.element_size()
    return T_local * frame, int(tj.max() - tj.min() + 1) * frame


def chunk_times(torch, smi_line, r):
    """The chunk-mode kernels at the slice shape (r: chunk_kernel_case's
    float t0 = 4 case) against their plain chunk versions, with their
    bounds from these inputs. Returns {kernel: dict(ms, plain_ms,
    bound_ms, bound_by)}."""
    from stnls_tpu_torch.attn_step import cuda_ms
    from stnls_tpu_torch.ops import nls_cuda, nls_vol_cuda

    def nb(*xs):
        return sum(x.numel() * x.element_size() for x in xs)

    plain = dict(n=3, warm=1)
    v0p, v1p, fl = r["b1_args"]
    F, taps = v0p.shape[3], r["b1_kw"]["ps"] ** 2
    with torch.no_grad():
        t = {"B1": (cuda_ms(lambda: nls_cuda.nls_topk(*r["b1_args"],
                                                      **r["b1_kw"])),
                    cuda_ms(lambda: nls_cuda.nls_topk_plain(
                        *r["b1_args"], **r["b1_kw"]), **plain)),
             "B5": (cuda_ms(lambda: nls_vol_cuda.nls_volume(
                        *r["b5_args"], **r["b5_kw"])),
                    cuda_ms(lambda: nls_vol_cuda.nls_volume_plain(
                        *r["b5_args"], **r["b5_kw"]), **plain))}
    t["B6"] = (cuda_ms(lambda: nls_vol_cuda.nls_volume_bwd(*r["b6_args"])),
               cuda_ms(lambda: nls_vol_cuda.nls_volume_bwd_plain(
                   *r["b6_args"]), **plain))
    t["B2"] = (cuda_ms(lambda: nls_cuda.nls_topk_bwd(*r["b2_args"])),
               cuda_ms(lambda: nls_cuda.nls_topk_bwd_plain(*r["b2_args"]),
                       **plain))
    b2 = r["b2_args"]
    # vid0 (and its gradient) over the query frames only; vid1 (and its
    # gradient) over the frames some query's window reaches
    q, reach = chunk_frame_bytes(r)
    bounds = {
        "B1": bound_ms(q + reach + nb(fl, r["d_k"], r["c_k"]),
                       r["d"].numel() * taps * F * FLOPS_PER_TAP["B1"]),
        "B5": bound_ms(q + reach + nb(*r["b5_args"][2:], r["d"]),
                       int(r["d"].isfinite().sum()) * taps * F
                       * FLOPS_PER_TAP["B5"]),
        "B6": bound_ms(2 * (q + reach) + nb(*r["b6_args"][2:5])
                       + nb(*r["b6_args"][2:4]),
                       r["active6"] * taps * F * FLOPS_PER_TAP["B6"]),
        "B2": bound_ms(2 * (q + reach) + nb(*b2[2:4], b2[4].int(), b2[6])
                       + nb(*b2[2:4]),
                       r["active2"] * taps * F * FLOPS_PER_TAP["B2"])}
    log(f"[times] {smi_line}: chunk mode at the slice (3, 8), "
        f"{v0p.shape[-1]}^2, "
        f"{CHUNK_SLICE['T_local']} query frames of {CHUNK_SLICE['T']} with "
        f"halos of {CHUNK_SLICE['halo']}: " + "; ".join(
            f"{key} {ms:.3f} ms (plain {pms:.3f}, bound "
            f"{bounds[key][0]:.4f} by {bounds[key][1]})"
            for key, (ms, pms) in t.items()))
    return {key: dict(ms=t[key][0], plain_ms=t[key][1],
                      bound_ms=bounds[key][0], bound_by=bounds[key][1])
            for key in t}


def time_sharded_phase(torch, dev, mesh, matrix, smi_line, H=128):
    """(c) time_sharded_search at config 7's published size on the mesh,
    forward and backward into the video (mean(d^2), as the config-7 step),
    against matrix_steps' config-7 step on the same inputs: dists
    and offsets equal, the loss at TOL, the video gradient at TOL *
    max|ref|; launch counts (B1, B2; no volume kernel, no plain backward),
    times in turns and peak memory. Then on the volume route at the
    slice's widths (K = 80 ranked slots over B1's 64) against
    plain_route(). Returns the numbers and the launch counts."""
    from stnls_tpu_torch.attn_step import cuda_ms
    from stnls_tpu_torch.parallel import time_sharded_search
    name = "align1080p_fwd+bwd"
    step, inputs = matrix[name][:2]
    sharded_step = sharded_config7_step(torch, mesh)

    def sharded():
        return sharded_step(*inputs)

    ref = step(*inputs)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    reset_counts()
    mine = sharded()
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated(dev) - base) / 1e9
    launches, plain_calls = read_counts()
    require(launches["nls_topk_fwd"] > 0 and launches["nls_topk_bwd"] > 0
            and launches["nls_vol_fwd"] == 0 and not any(plain_calls.values()),
            f"time-sharded config 7: launches {launches}, plain calls "
            f"{plain_calls}")
    require(torch.equal(mine["dists"], ref["dists"]) and
            torch.equal(mine["inds"], ref["inds"]),
            "time-sharded config 7: dists or offsets differ from the "
            "config-7 step's")
    close(mine["loss"], ref["loss"], "time-sharded config 7 loss")
    g_err, g_scale = grad_close(mine["g_vid"], ref["g_vid"],
                                "time-sharded config 7 g_vid")
    del mine, ref
    t = [cuda_ms(lambda: step(*inputs), n=5, warm=1),
         cuda_ms(sharded, n=5, warm=1), cuda_ms(sharded, n=5, warm=1),
         cuda_ms(lambda: step(*inputs), n=5, warm=1)]
    log(f"[sharded] {name} through time_sharded_search on a one-rank NCCL "
        f"mesh: dists and offsets equal to the config-7 step's, g_vid max|g| "
        f"{g_scale:.3e} max|err| {g_err:.3e}; launches {launches}; peak "
        f"{peak:.3f} GB")
    log(f"[times] {smi_line}: {name} step / time-sharded, in turns: "
        f"{t[0]:.3f} / {t[1]:.3f} / {t[2]:.3f} / {t[3]:.3f} ms")

    # the volume route at the slice's widths
    rng = np.random.default_rng(SEED + 15)
    v0, v1, fl = make_inputs(torch, rng, dev, B=1, HD=2, T=5, F=8, H=H,
                             W=H, wt=2)

    def volume():
        a, b = v0.clone().requires_grad_(), v1.clone().requires_grad_()
        d, i = time_sharded_search(a, b, fl, mesh, ws=5, wt=2, ps=3, k=80,
                                   stride1=0.5, self_action="anchor")
        cot = torch.from_numpy(np.random.default_rng(SEED + 16)
                               .standard_normal(tuple(d.shape))
                               .astype(np.float32)).to(dev)
        return (d.detach(), i.detach()) + torch.autograd.grad(
            (d * cot).sum(), (a, b))

    reset_counts()
    out = volume()
    torch.cuda.synchronize()
    v_launches, plain_calls = read_counts()
    require(v_launches["nls_vol_fwd"] > 0 and v_launches["nls_vol_bwd"] > 0
            and v_launches["nls_topk_fwd"] == 0 and
            not any(plain_calls.values()),
            f"time-sharded K = 80: launches {v_launches}")
    with plain_route():
        ref = volume()
    require(tuple(out[0].shape[-1:]) == (80,) and
            torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1]),
            "time-sharded K = 80: dists or offsets differ from the plain "
            "route's")
    v_err = max(grad_close(a, b, f"time-sharded K = 80 {what}")[0]
                for a, b, what in zip(out[2:], ref[2:], ("g_vid0",
                                                         "g_vid1")))
    log(f"[sharded] slice widths, K = 80, volume route: launches "
        f"{v_launches}; dists and offsets equal to the plain route's, "
        f"gradients max|kernels-plain| {v_err:.3e}")
    return dict(ms=t, peak_gb=peak, g_err=g_err, v_err=v_err,
                launches=launches, v_launches=v_launches)


def twin_phase(torch, dev, mesh, smi_line, widths=None):
    """(d) the twin of dryrun_multichip (stnls_tpu_torch/multichip_step)
    at the bench slice's widths (multichip_step.BENCH_WIDTHS) on the mesh:
    SGD_STEPS steps through the kernels (B1, B2, B3, B4 launched, no
    plain version called) and through plain_route(); the losses at TOL,
    the first step's gradients and each parameter's change over the
    steps at TOL * max|ref|, every parameter moved. Returns the launch
    counts, the errors and the step's time."""
    from stnls_tpu_torch import multichip_step as ms
    from stnls_tpu_torch.attn_step import cuda_ms
    axes = ms.mesh_axes(1)
    widths = ms.BENCH_WIDTHS if widths is None else widths
    vid, tgt, flows, params, cfg = ms.make_inputs(axes, SEED, dev, **widths)

    def run(steps=SGD_STEPS):
        return ms.train(mesh, vid, tgt, flows, params, cfg, steps=steps)

    reset_counts()
    new, hist = run(1)
    torch.cuda.synchronize()
    launches, plain_calls = read_counts()
    require(all(launches[k] > 0 for k in ("nls_topk_fwd", "nls_topk_bwd",
                                          "agg_gather_fwd",
                                          "agg_gather_bwd"))
            and not any(plain_calls.values()),
            f"twin: launches {launches}, plain calls {plain_calls}")
    new, hist = run()
    with plain_route():
        ref_new, ref_hist = run()
    errs = {}
    for step_i, ((loss, _), (ref_loss, _)) in enumerate(zip(hist,
                                                            ref_hist)):
        close(loss, ref_loss, f"twin loss of step {step_i}")
    for key in params:
        errs[f"grad {key}"] = grad_close(hist[0][1][key], ref_hist[0][1][key],
                                         f"twin grad {key}")[0]
        errs[f"update {key}"] = grad_close(
            new[key] - params[key], ref_new[key] - params[key],
            f"twin update of {key}")[0]
        require(bool((new[key] != params[key]).any()),
                f"twin: SGD left {key} unchanged")
    # the dryrun's check: the parameters move (its loss, near 1, moves by
    # about one float32 ulp a step at lr = 1e-2)
    losses = [float(x[0]) for x in hist]
    t = cuda_ms(lambda: run(1), n=5, warm=1)
    log(f"[twin] dryrun_multichip's step at the widths {widths}, "
        f"B = {vid.shape[0]}, T = {vid.shape[1]}, one-rank mesh: launches "
        f"{launches}; losses {losses} (plain route "
        f"{[float(x[0]) for x in ref_hist]}); max|kernels-plain| "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    log(f"[times] {smi_line}: twin train step {t:.3f} ms")
    return dict(launches=launches, err=max(errs.values()), ms=t,
                losses=losses)


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

    from stnls_tpu_torch.ops import cuda_lib, nls_cuda, nls_vol_cuda, \
        agg_cuda
    from stnls_tpu_torch.attn_step import AttnStep, attention_module, \
        cuda_ms, smooth_flows, VOLUME_SEARCH
    from stnls_tpu_torch.utils.config import ConfigDict

    # 2. the build
    build_phase(cuda_lib)

    # 3. each kernel against its plain version
    res = kernel_phase(torch, dev, "slice 128^2", dict(H=128, wt=2, k=10,
                                                       stride1=0.5))
    graft = kernel_phase(torch, dev, "graft 64^2", dict(H=64, wt=1, k=8,
                                                        stride1=1))
    vres = volume_kernel_phase(torch, dev, "slice 128^2",
                               dict(H=128, wt=2, stride1=0.5))
    vgraft = volume_kernel_phase(torch, dev, "graft 64^2",
                                 dict(H=64, wt=1, stride1=1))

    # 4. the forward path at full width
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
    target = torch.from_numpy(rng.standard_normal((B, T, F, H, W))
                              .astype(np.float32)).to(dev)
    flows = ConfigDict(fflow=fflow, bflow=bflow)
    data = (vid, fflow, bflow, proj_w, stack_w, target)
    attn = attention_module(SEED + 1, dev)
    step = AttnStep()

    reset_counts()
    with torch.no_grad():
        out_attn, _ = attn(vid, flows)
        out_step = step(vid, fflow, bflow, proj_w, stack_w)
    torch.cuda.synchronize()
    fwd_launches = read_counts()[0]
    log(f"[forward] launches on the forward path: {fwd_launches}")
    require(fwd_launches["nls_topk_fwd"] > 0 and
            fwd_launches["agg_gather_fwd"] > 0,
            "a kernel of the forward path was never launched")
    with torch.no_grad(), plain_route():
        ref_attn, _ = attn(vid, flows)
        ref_step = step(vid, fflow, bflow, proj_w, stack_w)
    for out, ref, what in ((out_attn, ref_attn, "NonLocalAttention"),
                           (out_step, ref_step, "bench attention step")):
        require(tuple(out.shape) == (B, T, F, H, W),
                f"{what}: shape {tuple(out.shape)}")
        require(bool(torch.isfinite(out).all()), f"{what}: non-finite")
        err = close(out, ref, f"{what} kernels vs plain")
        log(f"[forward] {what}: out {tuple(out.shape)}, max|kernels-plain| "
            f"{err:.3e}")

    # 5. the training path: through the kernels, then the plain route.
    # The bench step's flow gradient is 0 on both routes: q = k there, so
    # softmax(-10 d) puts all weight on the zero-distance self slot.
    geo = dict(wt=step.search.wt, ps=step.search.ps)
    train_launches = check_routes(
        torch, "train", lambda: train_path(torch, attn, step, data),
        ("nls_topk_fwd", "nls_topk_bwd", "agg_gather_fwd", "agg_gather_bwd"),
        attn, step, data, geo)

    # 6. the volume path: NonLocalAttention with per-frame top-K
    vattn = attention_module(SEED + 1, dev, search=VOLUME_SEARCH)
    reset_counts()
    with torch.no_grad():
        out_v, _ = vattn(vid, flows)
    torch.cuda.synchronize()
    vol_fwd_launches = read_counts()[0]
    with torch.no_grad(), plain_route():
        ref_v, _ = vattn(vid, flows)
    require(tuple(out_v.shape) == (B, T, F, H, W) and
            bool(torch.isfinite(out_v).all()),
            f"volume NonLocalAttention: shape {tuple(out_v.shape)} or "
            "non-finite")
    # where B5's and the plain volume's rounding flips a per-frame top-2
    # at a near-tie, the routes gather other cells: those outputs are
    # left out and counted (flipped_reach)
    mine = route_search(torch, "NonLocalAttention", vattn, step, data)
    with plain_route():
        theirs = route_search(torch, "NonLocalAttention", vattn, step, data)
    mask, n_flip = flipped_reach(torch, tuple(out_v.shape), mine, theirs,
                                 output=True, **geo)
    err = close(out_v.masked_fill(mask, 0.), ref_v.masked_fill(mask, 0.),
                "volume NonLocalAttention kernels vs plain")
    log(f"[volume] forward launches {vol_fwd_launches}; out "
        f"{tuple(out_v.shape)}, max|kernels-plain| {err:.3e} away from the "
        f"{n_flip} queries whose per-frame top-2 flipped at a near-tie "
        f"({float(mask.float().mean()):.4%} of the outputs left out; "
        f"max|kernels-plain| there "
        f"{float((out_v - ref_v).abs().max()):.3e})")
    require(vol_fwd_launches["nls_vol_fwd"] > 0 and
            vol_fwd_launches["agg_gather_fwd"] > 0 and
            vol_fwd_launches["nls_topk_fwd"] == 0,
            "the volume path's forward did not run through B5 and B3")
    vol_launches = check_routes(
        torch, "volume", lambda: attn_train_path(torch, vattn, data),
        ("nls_vol_fwd", "nls_vol_bwd", "agg_gather_fwd", "agg_gather_bwd"),
        vattn, step, data, geo)

    # 7. times at the slice config
    vid0, vid1, sflows, weights, inds = res["inputs"]
    kw = res["kw"]

    def fwd_bwd():
        v, f = vid.clone().requires_grad_(), fflow.clone().requires_grad_()
        out = step(v, f, bflow, proj_w, stack_w)
        torch.autograd.grad(out.pow(2).mean(), (v, f))

    with torch.no_grad():
        t_b1 = cuda_ms(lambda: nls_cuda.nls_topk(vid0, vid1, sflows,
                                                        **kw))
        t_b1p = cuda_ms(lambda: nls_cuda.nls_topk_plain(
            vid0, vid1, sflows, **kw))
        t_b3 = cuda_ms(lambda: agg_cuda.nl_gather_stack(
            vid1, weights, inds, ps=3, stride0=1))
        t_b3p = cuda_ms(lambda: agg_cuda.nl_gather_stack_plain(
            vid1, weights, inds, ps=3, stride0=1))
        t_b2 = cuda_ms(lambda: nls_cuda.nls_topk_bwd(*res["b2_args"]))
        t_b4 = cuda_ms(lambda: agg_cuda.nl_gather_stack_bwd(
            *res["b4_args"]))
        t_step = cuda_ms(lambda: step(vid, fflow, bflow, proj_w,
                                             stack_w))
        with plain_route():
            t_stepp = cuda_ms(lambda: step(vid, fflow, bflow, proj_w,
                                                  stack_w))
    t_b2p = cuda_ms(lambda: nls_cuda.nls_topk_bwd_plain(
        *res["b2_args"]))
    t_b4p = cuda_ms(lambda: agg_cuda._gather_bwd_plain(
        *res["b4_args"]))
    t_train = cuda_ms(fwd_bwd)
    with plain_route():
        t_trainp = cuda_ms(fwd_bwd, n=5)
    b5_args, b5_kw, b6_args = vres["b5_args"], vres["b5_kw"], vres["b6_args"]
    with torch.no_grad():
        t_b5 = cuda_ms(lambda: nls_vol_cuda.nls_volume(*b5_args, **b5_kw))
        t_b5p = cuda_ms(lambda: nls_vol_cuda.nls_volume_plain(
            *b5_args, **b5_kw), n=3, warm=1)
        t_b6 = {kind: cuda_ms(lambda: nls_vol_cuda.nls_volume_bwd(*args))
                for kind, args in b6_args.items()}
    t_b6p = {kind: cuda_ms(lambda: nls_vol_cuda.nls_volume_bwd_plain(*args),
                           n=3, warm=1) for kind, args in b6_args.items()}

    def vol_fwd():
        with torch.no_grad():
            vattn(vid, flows)

    def vol_fwd_bwd():
        v, f = vid.clone().requires_grad_(), fflow.clone().requires_grad_()
        out, _ = vattn(v, ConfigDict(fflow=f, bflow=bflow))
        torch.autograd.grad(out.pow(2).mean(), [v, f]
                            + list(vattn.parameters()))

    t_vol = cuda_ms(vol_fwd)
    t_vol_train = cuda_ms(vol_fwd_bwd)
    with plain_route():
        t_volp = cuda_ms(vol_fwd, n=3, warm=1)
        t_vol_trainp = cuda_ms(vol_fwd_bwd, n=3, warm=1)
    log(f"[times] {smi_line}: B5 {t_b5:.3f} ms (plain {t_b5p:.3f}, bound "
        f"{vres['bounds']['B5'][0]:.3f}); " + "; ".join(
            f"B6 {kind} {t_b6[kind]:.3f} ms (plain {t_b6p[kind]:.3f}, bound "
            f"{vres['bounds'][f'B6 {kind}'][0]:.3f})" for kind in t_b6))
    log(f"[times] {smi_line}: volume NonLocalAttention forward {t_vol:.3f} "
        f"ms = {T / (t_vol / 1e3):.1f} frames/s (plain {t_volp:.3f} ms); "
        f"fwd+bwd {t_vol_train:.3f} ms = {T / (t_vol_train / 1e3):.2f} "
        f"frames/s (plain {t_vol_trainp:.3f} ms)")
    log(f"[times] {smi_line}: B1 {t_b1:.3f} ms (plain {t_b1p:.3f}); "
        f"B2 {t_b2:.3f} ms (plain {t_b2p:.3f}); B3 {t_b3:.3f} ms (plain "
        f"{t_b3p:.3f}); B4 {t_b4:.3f} ms (plain {t_b4p:.3f})")
    log(f"[times] {smi_line}: forward step {t_step:.3f} ms = "
        f"{T / (t_step / 1e3):.1f} frames/s (plain {t_stepp:.3f} ms); "
        f"fwd+bwd step {t_train:.3f} ms = {T / (t_train / 1e3):.2f} "
        f"frames/s (plain {t_trainp:.3f} ms)")

    # 8. the aggregation kernels against their plain versions
    from stnls_tpu_torch import agg_example
    from stnls_tpu_torch.ops import agg_sp_cuda as sp
    from stnls_tpu_torch.search.utils import shape_vids
    a_cfg = agg_example.CONFIG
    a_in = agg_example.make_inputs(SEED, device=dev, **a_cfg)
    d_a, o_a = agg_example.search(*a_in, **a_cfg)
    v6_a = shape_vids(a_cfg["HD"], [a_in[0]])[0].contiguous()
    w_a = torch.softmax(-10. * d_a, -1).contiguous()
    a1 = dict(ps=3, pt=1, dilation=1, reflect_bounds=True, use_adj=False)
    ares = agg_kernel_phase(
        torch, dev, "agg example 128^2", (v6_a, w_a, o_a.contiguous()),
        dict(a1, strideIn=1, strideOut=1), dict(a1, stride0=1))
    a2 = dict(ps=4, pt=2, dilation=2, reflect_bounds=True, use_adj=True)
    ares2 = agg_kernel_phase(
        torch, dev, "strided 64^2", agg_inputs(torch, dev),
        dict(a2, strideIn=2, strideOut=2), dict(a2, stride0=2))

    # 9. the agg example's twin at full width
    agg_twin = agg_example_phase(torch, dev)

    # 10. times of B7-B10 and of the twin
    with torch.no_grad():
        t_agg = {}
        for key, fwd, plain in (("B7", sp.nl_scatter_add,
                                 sp.nl_scatter_add_plain),
                                ("B9", sp.nl_pool, sp.nl_pool_plain)):
            args, cfg = ares["args"][key]
            t_agg[key] = (cuda_ms(lambda: fwd(*args, **cfg)),
                          cuda_ms(lambda: plain(*args, **cfg), n=5, warm=1))
        for key, bwd, plain in (("B8", sp.nl_scatter_add_bwd,
                                 sp._scatter_add_bwd_plain),
                                ("B10", sp.nl_pool_bwd,
                                 sp._pool_bwd_plain)):
            args = ares["args"][key]
            t_agg[key] = (cuda_ms(lambda: bwd(*args)),
                          cuda_ms(lambda: plain(*args), n=5, warm=1))
    v6_t, w_t, o_t = agg_twin["search"]
    t_aggs = cuda_ms(lambda: agg_example.aggregate(v6_t, w_t, o_t, **a_cfg))
    with plain_route():
        t_aggsp = cuda_ms(lambda: agg_example.aggregate(v6_t, w_t, o_t,
                                                        **a_cfg), n=3, warm=1)
    t_twin = cuda_ms(lambda: agg_example.run(*agg_twin["inputs"], a_cfg))
    log(f"[times] {smi_line}: " + "; ".join(
        f"{key} {t_agg[key][0]:.3f} ms (plain {t_agg[key][1]:.3f}, bound "
        f"{ares['bounds'][key][0]:.4f} by {ares['bounds'][key][1]})"
        for key in ("B7", "B8", "B9", "B10")))
    log(f"[times] {smi_line}: agg example, the four aggregators fwd+bwd "
        f"{t_aggs:.3f} ms (plain route {t_aggsp:.3f} ms); search + the four "
        f"{t_twin:.3f} ms")

    # 11. B1, B5 and B6 at other (ps, F a head), and K beyond B1's list
    err_ps = ps_kernel_phase(torch, dev)

    # 12. benchmarks/matrix.py's configs 1, 4, 5 and 7 at full size, and
    # config 7's B1 and B2 against their plain versions on its whole frames
    matrix = matrix_phase(torch, dev)
    err_full = full_frame_phase(torch, "align1080p_fwd+bwd",
                                matrix["align1080p_fwd+bwd"][1])

    # 13. times: the matrix steps; B1, B5 and B6 at (1, 2) and (1, 16);
    # the compiled bodies of B1 and B5 against the run-time one
    t_matrix = {name: cuda_ms(lambda: step(*inputs), n=5, warm=1)
                for name, (step, inputs, _, _) in matrix.items()}
    log(f"[times] {smi_line}: matrix steps " + "; ".join(
        f"{name} {ms:.3f} ms = "
        f"{matrix[name][1][0].shape[1] / (ms / 1e3):.2f} frames/s "
        f"(peak {matrix[name][3]:.3f} GB)" for name, ms in t_matrix.items()))
    ps1 = ps1_kernel_times(torch, dev, smi_line, matrix)
    spec = compiled_vs_run_time(torch, dev, smi_line, res, vres)

    # 14. time sharding: the chunk mode of B1, B2, B5 and B6 against their
    # plain versions and against the whole video; time_sharded_search at
    # config 7's size and the twin of dryrun_multichip on a one-rank mesh
    chunk = chunk_kernel_phase(torch, dev)
    chunk_whole_1080p(torch, matrix)
    t_chunk = chunk_times(torch, smi_line, chunk["timing"])
    del chunk["timing"]
    from stnls_tpu_torch.multichip_step import one_rank_mesh
    torch.cuda.set_device(dev)
    with one_rank_mesh() as mesh:
        sharded = time_sharded_phase(torch, dev, mesh, matrix, smi_line)
        twin = twin_phase(torch, dev, mesh, smi_line)

    require("jax" not in sys.modules, "JAX was imported")
    rows = (("B1", "nls_topk_fwd", "nls_pallas.py:761", t_b1, t_b1p),
            ("B2", "nls_topk_bwd", "nls_pallas_bwd.py:675", t_b2, t_b2p),
            ("B3", "agg_gather_fwd", "agg_pallas.py:408", t_b3, t_b3p),
            ("B4", "agg_gather_bwd", "agg_pallas_bwd.py:244", t_b4, t_b4p))
    # B5 and B6 on the volume path (B6 on its sparse per-frame top-K
    # cotangent); launches from the paths' kernel routes
    rows += (("B5", "nls_vol_fwd", "nls_pallas.py:705", t_b5, t_b5p),
             ("B6", "nls_vol_bwd", "nls_pallas_bwd.py:733", t_b6["each"],
              t_b6p["each"]))
    # B7-B10 on the agg example's twin (times at its config)
    rows += tuple((key, name, site) + t_agg[key] for key, name, site in (
        ("B7", "agg_scatter_add_fwd", "agg_pallas_sp.py:269"),
        ("B8", "agg_scatter_add_bwd", "agg_pallas_sp.py:440"),
        ("B9", "agg_pool_fwd", "agg_pallas_sp.py:756"),
        ("B10", "agg_pool_bwd", "agg_pallas_sp.py:917")))
    bounds = dict(res["bounds"], B5=vres["bounds"]["B5"],
                  B6=vres["bounds"]["B6 each"], **ares["bounds"])
    errs = {key: max(r["err"][key], g["err"][key])
            for r, g in ((res, graft), (vres, vgraft), (ares, ares2))
            for key in r["err"]}
    errs["B6"] = max(errs["B6"], err_ps)
    errs["B2"] = max(errs["B2"], err_full)
    # the chunk mode's launches, path by path, each read from its own run:
    # the time-sharded config 7 (B1, B2), the volume route at K = 80 (B5,
    # B6) and one train step of the twin (B1, B2)
    chunk_launches = {
        name: {"config7_sharded": sharded["launches"][name],
               "volume_k80": sharded["v_launches"][name],
               "twin": twin["launches"][name]}
        for name in ("nls_topk_fwd", "nls_topk_bwd", "nls_vol_fwd",
                     "nls_vol_bwd")}
    chunk_errs = dict(chunk["errs"], B1=0., B5=0.)
    chunk_errs["B6"] = max(chunk_errs["B6"], sharded["v_err"])
    kernels = []
    for key, name, site, ms, plain_ms in rows:
        b_ms, b_by = bounds[key]
        launches = vol_launches if key in ("B5", "B6") else \
            agg_twin["launches"] if key in ("B7", "B8", "B9", "B10") else \
            train_launches
        entry = {
            "name": name, "route": "cuda",
            "source": f"stnls_tpu_torch/csrc/{name}.cu",
            "replaces": f"stnls_tpu/ops/{site}",
            "launches": launches[name], "max_abs_err": errs[key],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None}
        if key in t_chunk:
            entry["chunk"] = dict(t_chunk[key],
                                  launches=chunk_launches[name],
                                  max_abs_err=chunk_errs[key],
                                  library_ms=None)
        kernels.append(entry)
    print(json.dumps({"steps": {
        "forward_ms": t_step, "forward_plain_ms": t_stepp,
        "forward_frames_per_s": T / (t_step / 1e3),
        "fwd_bwd_ms": t_train, "fwd_bwd_plain_ms": t_trainp,
        "fwd_bwd_frames_per_s": T / (t_train / 1e3),
        "volume_forward_ms": t_vol, "volume_forward_plain_ms": t_volp,
        "volume_fwd_bwd_ms": t_vol_train,
        "volume_fwd_bwd_plain_ms": t_vol_trainp,
        "b6_dense_ms": t_b6["dense"], "b6_dense_plain_ms": t_b6p["dense"],
        "b6_dense_bound_ms": vres["bounds"]["B6 dense"][0],
        "agg_example_aggregators_fwd_bwd_ms": t_aggs,
        "agg_example_aggregators_fwd_bwd_plain_ms": t_aggsp,
        "agg_example_ms": t_twin,
        "matrix": {name: {
            "ms": ms, "frames_per_s": matrix[name][1][0].shape[1] / (ms / 1e3),
            "peak_gb": matrix[name][3]} for name, ms in t_matrix.items()},
        "ps1_kernels": ps1, "compiled_vs_run_time_ms": spec,
        "time_sharded_config7": {
            "step_ms_in_turns": sharded["ms"][0::3],
            "time_sharded_ms_in_turns": sharded["ms"][1:3],
            "peak_gb": sharded["peak_gb"]},
        "multichip_twin": {"train_step_ms": twin["ms"],
                           "losses": twin["losses"]}}}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
