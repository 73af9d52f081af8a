"""Drive the PyTorch + CUDA port's main paths once on one NVIDIA GPU.

Run from the repository root: python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:
  1. the card: name and power limit;
  2. the build of the hand-written CUDA kernels (stnls_tpu_torch/csrc);
  3. each kernel against its plain PyTorch version on the card, at the
     slice config (128^2, wt=2, K=10, stride1=0.5) and the
     __graft_entry__ config (64^2, wt=1, K=8, stride1=1): B1 search
     top-K, B2 search backward (with its global atomic instructions a
     backward, against the first version's ps^2 * F * 5 per active
     (q, k): at least 4x fewer at the slice), B3 gather, B4 gather
     backward, B5 search
     volume and B6 its backward (on a dense cotangent, as
     topk_mode="none" gives, and on the sparse one of anchor_each with
     per-frame top-2; at 64^2 also remove_ref_frame's, the int path and
     prod distances; centre gradients compared off integer lattice
     positions), with B6's global atomic instructions a backward against
     the first design's a scalar one per (active cell, tap, channel,
     corner): at least 8x fewer on the slice's dense cotangent;
  4. the forward path at full width (B=1, T=5, F=16, 128^2):
     NonLocalAttention and the bench attention step, through the kernels
     and through the plain versions (`plain_route`), with launch counts;
  5. the training path at full width: forward and backward of the bench
     step and of NonLocalAttention into the video, the flows and the
     parameters, then 3 SGD steps of NonLocalAttention towards a fixed
     target, through the kernels (launch counts of B1-B4 and of the
     geometry kernels G1 and G2, no plain backward called), through the
     plain backwards on the kernels' forward and through the plain route
     (which swaps G1 and G2 too); gradients and each parameter's
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
     its search's weights and offsets), at a second one (64^2, strides
     2, dilation 2, use_adj, ps 4 (pool: 5), pt 2, half-integer offsets,
     -1e8 fills, weights below 1e-8 and negative), at the agg example's
     config on 512^2 frames and on its 128^2 video and offsets with
     seeded uniform (0, 1] weights ("dense": every slot live, the
     destinations scattered); B9's output, B8's gradients and B10's
     weight gradient bitwise equal on two calls;
  9. the agg example's twin (stnls_tpu_torch/agg_example.py) at full width
     (B=1, T=3, F=16, HD=2, 128^2, K=8): one search, then Gather,
     GatherAdd, ScatterAdd and Pool forward and the gradients of
     mean(out^2) to the video, the weights and the offsets, through the
     kernels (launch counts of B1, B3, B4, B7-B10; no plain backward) and
     through the plain route on the same search outputs; every gradient
     compared is non-zero, the offsets' gradients of ScatterAdd and Pool
     are exactly 0;
 10. the times of B7-B10 and of the twin, and of B7-B10 at 512^2, on
     the dense case and on the strided 64^2 with their bounds;
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
     on a 270x480 crop for 5 and 7, under the rules of phase 5; B2 on
     config 7's whole frames (its time, bound and global atomics, at
     least 2x fewer than the first version's) and on config 4's, each on
     a seeded cotangent at B1's cells;
 13. times: the four matrix steps; B1, B5 and B6 at (ps, F a head) =
     (1, 2) and (1, 16) against their plain versions, with their bounds;
     the bodies of B1 and B5 with (ps, F) compiled in (B1 (3, 8) and
     (1, 2); B5 (3, 8) and (3, 16)) against the run-time body;
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
     through the kernels (B1-B4) and through plain_route(), and B3's time
     and bound at the arguments of the twin's gather. A multi-card ring
     exchange is not run: one card holds one rank;
 15. the model layer: (a) benchmarks/matrix.py's config 6, the
     NonLocalDenoiser train step (stnls_tpu_torch/matrix_steps.py,
     parameters from a seeded torch.Generator) at its published 540x960,
     T 3: one step through the kernels (one launch each of B1-B4 and G1, no
     plain backward), the output and every parameter's gradient finite
     and non-zero, 3 SGD steps lowering the loss, its time, frames/s and
     peak memory, and B1-B4's times and bounds at the arguments the step
     gives them; (b) the same step and SGD steps on a 270x480 crop
     against the plain backwards on the kernels' forward and against
     plain_route(), under the rules of phase 5; (c)
     NonLocalAttentionStack and NonLocalAttention with StackConv at the
     slice's widths, forward against plain_route() and the training path
     of phase 5; (d) vnlb (int search, ps 5, through B1) on a seeded
     smooth noisy RGB video (128^2, T 5): offsets equal to the plain
     route's, the output at 1e-4, the PSNR gain (> 4 dB), its time and
     its Bayes filter's (batched eigh), and flow_patches.get_mse scoring
     the video's true motion below zero flow;
 16. the search layer: (a) the twin of benchmarks/search_bench.py
     (stnls_tpu_torch/search_bench.py) at its full size (512^2, T 3, 3
     heads of F 9, ws 21, wt 3, ps 7, K 10): NonLocalSearch float and
     int, RefineSearch (wr 3) on the float search's offsets and the
     refine's forward and backward, each call's time over SB_REPS calls
     and its peak memory, one B1 launch a search call and one B2 launch a
     refine backward; B1's and B2's times and bounds at those arguments;
     (b) B1 (float and int, bitwise, head by head) and B2 (seeded
     cotangent) at (ps 7, F 9, ws 21, W_t 3) on a 96^2 crop against their
     plain versions; (c) the refine on a 32^2 crop, its selection in 8
     bands against the whole plain lattice and its B2 gradients against
     the lattice's autograd; (d) PairedSearch (lazy and anchored),
     PairedRefine, RandIndsSearch, N3MatMultSearch and NonLocalSearch's
     lattice route (pt 2, reflect_bounds=False) at 16^2 on the card
     against the CPU; (e) NonLocalAttentionStack's two stages at the
     slice's widths, the second a refine with ref_itype="int", through
     B1-B4 against plain_route();
 17. the scatter path at the slice's widths (B 1, T 5, 2 heads of F 8,
     128^2, smooth flows rounded to integers): NonLocalSearch (ws 5, wt 2,
     ps 3, K 10, stride1 1, anchored, itype "int": B1), w = softmax(-10 d),
     graph_opts.scatter_labels, NonLocalScatter (S = labels.max()+1),
     scatter_tensor and gather_tensor of w and run_topk, and the gradient
     of mean(stack.sum(2)^2) into the video (B2 and autograd), through
     the kernels (B1, B2 and G1 once each, no plain backward) and through
     plain_route(): offsets, labels, names, mask and the top-K's labels
     equal, the stack, the scattered and gathered weights and the gradient
     at 1e-4 * max|ref| and non-zero; its times, peak memory and S against
     slot_bound; B1's and B2's times, plain times and bounds there;
 18. the twin of benchmarks/agg_bench.py (stnls_tpu_torch/agg_bench.py)
     at its published 512^2, ps 7 (B 1, 2 heads of F 8, T 3, K 10):
     each aggregator's time a call and peak memory from the port's
     RecordIt, the launches of B3, B7 and B9, each output against its
     plain version at TOL, and B3's, B7's and B9's times, plain times and
     bounds there;
 19. the lazy route's geometry kernels at the arguments that config 7's
     step (1080p, 2 heads, T 10, W_t 7, K 10) and config 6's (540x960, 2
     heads, T 3, W_t 3, K 8) give G1: G1's positions, frames, validity
     and offsets bitwise equal to its plain version's (cells_geometry,
     the stacked offsets, the anchored slot) on the same card, G2's flow
     gradient from seeded cotangents at 1e-4 * max|ref| against autograd
     through that plain version, their times, plain times and bounds.
 20. RVRT's alignment (models/rvrt.Align) at rvrt256's widths (2 clips
     of 64^2 features, 12 heads of 32, ws 9, K 9, prod), forward and
     backward: one launch each of B1, G1, B3, B4 and B2 (counted from
     zero), B1's dists and offsets bitwise equal to the plain lazy
     route's, the output at TOL and every gradient at 1e-4 * max|ref|
     (or the median gradient's) against it, B2, B3 and B4 at their
     arguments against their plain versions, and their times and bounds
     there.
B2's, B3's, B5's, B6's and B7-B10's times are printed with those of
their previous design in parentheses (EARLIER_MS).
The line before the last is a JSON object of the kernels (G1 and G2 at
config 7's arguments, with a "config6" entry at config 6's; B1, B2, B5 and
B6 with a "chunk" entry of their chunk mode, B6 with a "stats" entry of
its global atomics at the slice, B1-B4 with a "config6" entry at config
6's arguments, B1 and B2 with a "search_bench" entry at the search
twin's and a "scatter_path" entry at phase 17's, B3, B7 and B9 with an
"agg_bench" entry at phase 18's, B1-B4 and G1 with an "rvrt256" entry at
phase 20's); the last line is {"ok": true,
"device": {...}}. The script imports nothing of JAX.
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
# G1 and G2 read no video: per selected cell, G1 adds the flow to the
# query, forms the lattice position (subtract, multiply, add) and the
# offset (subtract), on each axis (10); G2 adds the position's and the
# offset's cotangents into its slot, on each axis (4)
FLOPS_PER_CELL = {"G1": 10, "G2": 4}
# B2's, B3's, B5's, B6's and B7-B10's times before their redesign
# (B7-B10 at the agg example's 128^2, a call), as PERF.md
# section 6 records them (chip_smoke.py's CUDA events and, "device",
# profile_step.py's traces; NVIDIA H100 80GB HBM3, 700.00 W), printed in
# parentheses beside this run's
EARLIER_MS = {"B2 slice": 5.437, "B2 config 7 device": 90.965,
              "B2 config 4 device": 9.029, "B3 slice": 1.448,
              "B3 multichip twin device": 6.123,
              "B5 slice": 2.119, "B5 1,2": 6.399, "B5 1,16": 1.003,
              "B5 chunk": 1.776, "B6 slice each": 2.442,
              "B6 slice dense": 18.249, "B6 1,2": 7.437, "B6 1,16": 0.624,
              "B6 chunk": 1.966, "B7 agg example": 0.108,
              "B8 agg example": 0.226, "B9 agg example": 0.348,
              "B10 agg example": 0.146}
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
    # registers and spills of the kernels the main paths launch, and the
    # stack frame of each B1 body
    func = None
    b1_frames = {}
    for line in lib.log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            func = m.group(1)
            continue
        if not func:
            continue
        b1 = re.search(r"nls_topk_kernelILi(\d+)ELi(\d+)E", func)
        if b1 and "stack frame" in line:
            frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                              r"stores, (\d+) bytes spill loads", line)
            b1_frames[tuple(int(x) for x in b1.groups())] = frame.groups()
        if (b1 or "agg_" in func or "nls_topk_bwd" in func or
                "nls_vol" in func) and \
                ("registers" in line or "spill" in line):
            log(f"[build] ...{func[-44:]}: {line.strip()}")
    log("[build] B1 bodies ((ps, F); (0, 0) the run-time one): stack frame "
        "/ spill stores / spill loads bytes: " + "; ".join(
            f"{body}: {'/'.join(fr)}"
            for body, fr in sorted(b1_frames.items())))
    log("[build] B1 reads the key patches through L1/L2 (no shared key "
        "tile): every (block, time slot) pair reads vid1 from global "
        "memory, share 1.0")
    return secs


def counters():
    """The launch counts of the twelve kernels and the call counts of the
    plain backwards, by name."""
    from stnls_tpu_torch.ops import nls_cuda, nls_vol_cuda, agg_cuda, \
        agg_sp_cuda as sp, nls_geometry_cuda as geo
    return {"nls_topk_fwd": nls_cuda.nls_topk,
            "nls_topk_bwd": nls_cuda.nls_topk_bwd,
            "nls_geometry_fwd": geo.nls_geometry,
            "nls_geometry_bwd": geo.nls_geometry_bwd,
            "agg_gather_fwd": agg_cuda.nl_gather_stack,
            "agg_gather_bwd": agg_cuda.nl_gather_stack_bwd,
            "nls_vol_fwd": nls_vol_cuda.nls_volume,
            "nls_vol_bwd": nls_vol_cuda.nls_volume_bwd,
            "agg_scatter_add_fwd": sp.nl_scatter_add,
            "agg_scatter_add_bwd": sp.nl_scatter_add_bwd,
            "agg_pool_fwd": sp.nl_pool,
            "agg_pool_bwd": sp.nl_pool_bwd}, \
        {"nls_topk_bwd_plain": nls_cuda.nls_topk_bwd_plain,
         "nls_geometry_bwd_plain": geo.nls_geometry_bwd_plain,
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
    nls_cuda.nls_topk_bwd, nls_geometry_cuda.nls_geometry_bwd,
    nls_vol_cuda.nls_volume_bwd, agg_cuda.nl_gather_stack_bwd,
    agg_sp_cuda.nl_scatter_add_bwd and agg_sp_cuda.nl_pool_bwd and, with
    `forward`, non_local_search.nls_topk, non_local_search.nls_geometry,
    nls_vol_cuda.nls_volume, gather.nl_gather_stack,
    gather_add.nl_gather_stack, scatter_add.nl_scatter_add and
    pool.nl_pool) and checks that none of the swapped kernels launched."""
    from stnls_tpu_torch.search import non_local_search
    from stnls_tpu_torch.agg import gather, gather_add, scatter_add, pool
    from stnls_tpu_torch.ops import nls_cuda, nls_vol_cuda, agg_cuda, \
        agg_sp_cuda as sp, nls_geometry_cuda as geo
    names = [(nls_cuda, "nls_topk_bwd", nls_cuda.nls_topk_bwd_plain),
             (geo, "nls_geometry_bwd", geo.nls_geometry_bwd_plain),
             (nls_vol_cuda, "nls_volume_bwd",
              nls_vol_cuda.nls_volume_bwd_plain),
             (agg_cuda, "nl_gather_stack_bwd", agg_cuda._gather_bwd_plain),
             (sp, "nl_scatter_add_bwd", sp._scatter_add_bwd_plain),
             (sp, "nl_pool_bwd", sp._pool_bwd_plain)]
    if forward:
        names += [(non_local_search, "nls_topk", nls_cuda.nls_topk_plain),
                  (non_local_search, "nls_geometry", geo.nls_geometry_plain),
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
        "nls_topk_bwd", "nls_geometry_bwd", "nls_vol_bwd", "agg_gather_bwd",
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


def b2_work(args):
    """The bytes and float operations of B2 on its arguments (vid0, vid1,
    prop_h, prop_w, tj_k, valid, g_d, cfg): the inputs read once (the
    target frames as int32), the four gradients written once, and
    FLOPS_PER_TAP per (active (q, k), tap, channel)."""
    vid0, vid1, prop_h, prop_w, _, valid, g_d, cfg = args[:8]
    nbytes = sum(x.numel() * x.element_size() for x in (
        vid0, vid1, prop_h, prop_w, g_d)) + 4 * g_d.numel()
    nbytes += sum(x.numel() * x.element_size() for x in (
        vid0, vid1, prop_h, prop_w))
    active = int((valid & (g_d != 0)).sum())
    return nbytes, active * cfg["ps"] ** 2 * vid0.shape[3] \
        * FLOPS_PER_TAP["B2"]


def b2_atomics(torch, args):
    """B2's global atomic instructions a backward on `args` (the kernel's
    counts: into g_vid1, into g_vid0, plain stores into g_vid0, active
    (q, k)) and the first version's: ps^2 * F * 5 per active (q, k)."""
    from stnls_tpu_torch.ops import nls_cuda
    stats = torch.zeros(4, dtype=torch.int64, device=args[0].device)
    nls_cuda.nls_topk_bwd(*args, stats=stats)
    into1, into0, stores, active = stats.tolist()
    require(active == int((args[5] & (args[6] != 0)).sum()),
            "B2: the kernel's count of active (q, k) is wrong")
    first = active * args[7]["ps"] ** 2 * args[0].shape[3] * 5
    return dict(global_atomics=into1 + into0, into_g_vid1=into1,
                into_g_vid0=into0, g_vid0_stores=stores,
                active_pairs=active, first_version=first,
                fewer=first / max(into1 + into0, 1))


def b6_atomics(torch, args, d):
    """B6's global atomic instructions a backward on args (its wrapper's
    arguments; d the volume): the kernel's counts (into g_vid1, into
    g_vid0, active cells) and the first design's from the shapes, a
    scalar atomic per (active cell, tap, channel, bilinear corner) and
    per (active (query, slot), tap, channel)."""
    from stnls_tpu_torch.ops import nls_vol_cuda
    stats = torch.zeros(4, dtype=torch.int64, device=args[0].device)
    nls_vol_cuda.nls_volume_bwd(*args, stats=stats)
    into1, into0, _, cells = stats.tolist()
    live = (args[4] != 0) & d.isfinite()
    require(cells == int(live.sum()), f"B6 counted {cells} active cells, "
            f"not {int(live.sum())}")
    slots = int(live.flatten(4, 5).any(4).sum())
    taps_f = args[5]["ps"] ** 2 * args[0].shape[3]
    corners = 1 if args[5]["itype"] == "int" else 4
    return dict(into_vid1=into1, into_vid0=into0,
                global_atomics=into1 + into0, active_cells=cells,
                active_slots=slots,
                first_design=cells * taps_f * corners + slots * taps_f)


def nb(*xs):
    """The bytes of the tensors xs."""
    return sum(x.numel() * x.element_size() for x in xs)


def b1_work(vid0, vid1, flows, dists, cells, *, ws, wt, ps):
    """The bytes and float operations of B1 on its arguments and outputs:
    the inputs read once, dists and cells written once; FLOPS_PER_TAP per
    (query, window cell, tap, channel), every cell of the W_t * ws^2
    window valid (full_ws)."""
    cells_all = min(2 * wt + 1, vid1.shape[2]) * ws * ws
    return (nb(vid0, vid1, flows, dists, cells),
            dists[..., 0].numel() * cells_all * ps * ps * vid0.shape[3]
            * FLOPS_PER_TAP["B1"])


def b4_work(args):
    """The bytes and float operations of B4 on its arguments (vid,
    weights, flows, g_stack, cfg, needs): the inputs read once, the three
    gradients written once; FLOPS_PER_TAP per (query, slot, in-frame tap,
    channel) and the division by the overlap count once per cotangent
    element."""
    vid, weights, flows, g_stack, cfg = args[:5]
    B, HD, T, F, H, W = vid.shape
    nH, nW, K = flows.shape[-4:-1]
    taps = taps_in_frame(nH, H, cfg["ps"], cfg["stride0"]) * taps_in_frame(
        nW, W, cfg["ps"], cfg["stride0"]) * B * HD * T * K
    return (nb(vid, weights, flows, g_stack) + nb(vid, weights,
                                                          flows),
            taps * F * FLOPS_PER_TAP["B4"] + g_stack.numel())


def b3_work(vid, weights, inds, ps, stride0=1):
    """The bytes and float operations of B3: video, weights and offsets
    read once, the stack written once; FLOPS_PER_TAP per (output pixel,
    slot, in-frame tap, channel) and the division once per output."""
    B, HD, T, F, H, W = vid.shape
    nH, nW, K = inds.shape[-4:-1]
    out = B * HD * K * T * F * H * W
    taps = taps_in_frame(nH, H, ps, stride0) * taps_in_frame(
        nW, W, ps, stride0) * B * HD * T * K
    return (sum(x.numel() * x.element_size() for x in (vid, weights, inds))
            + 4 * out, taps * F * FLOPS_PER_TAP["B3"] + out)


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
    b2_at = b2_atomics(torch, b2_args)
    log(f"[kernels] B2 {name}: global atomics per backward "
        f"{b2_at['global_atomics']} ({b2_at['into_g_vid1']} into g_vid1, "
        f"{b2_at['into_g_vid0']} into g_vid0; {b2_at['g_vid0_stores']} "
        f"plain stores into g_vid0) for {b2_at['active_pairs']} active "
        f"(q, k); the first version's {b2_at['first_version']} "
        f"({b2_at['fewer']:.2f}x more)")
    require(b2_at["fewer"] >= 4, f"B2 {name}: fewer than 4x fewer global "
            "atomics than the first version")

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
    # B4's global atomics: the flush of the shared boxes and the entries
    # whose frame got no box, against the first version's one per (query,
    # slot, in-frame tap, channel, bilinear corner)
    stats = torch.zeros(4, dtype=torch.int64, device=dev)
    agg_cuda.nl_gather_stack_bwd(*b4_args, stats=stats)
    flush, direct, n_global, n_all = stats.tolist()
    first = taps_in_frame(H, H, 3) ** 2 * B * HD * T * c_k.shape[-1] * F * 4
    b4_atomics = dict(global_atomics=flush + direct, flush=flush,
                      direct=direct, first_version=first,
                      entries_global_share=n_global / max(n_all, 1))
    log(f"[kernels] B4 {name}: global atomics per backward {flush + direct} "
        f"({flush} flushed from shared boxes, {direct} of entries with no "
        f"box); the first version's {first} ("
        f"{first / max(flush + direct, 1):.1f}x more); entries sent to "
        f"global memory {n_global} of {n_all} (share "
        f"{n_global / max(n_all, 1):.4f})")

    # bounds at this config, from these inputs
    bounds = {
        "B1": bound_ms(*b1_work(vid0, vid1, flows, d_k, c_k, ws=5,
                                wt=cfg["wt"], ps=kw["ps"])),
        "B2": bound_ms(*b2_work(b2_args)),
        "B3": bound_ms(*b3_work(vid1, weights, inds, kw["ps"])),
        "B4": bound_ms(*b4_work(b4_args)),
    }
    return dict(err={"B1": err_b1, "B2": max(errs_b2), "B3": err_b3,
                     "B4": max(errs_b4)}, share=share, bounds=bounds,
                b4_atomics=b4_atomics, b2_atomics=b2_at,
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
            at = b6_atomics(torch, args, d)
            log(f"[kernels] B6 {name} {label} {kind}: global atomic "
                f"instructions a backward {at['global_atomics']} (into "
                f"g_vid1 {at['into_vid1']}, into g_vid0 {at['into_vid0']}) "
                f"against the first "
                f"design's {at['first_design']} "
                f"({at['first_design'] / max(at['global_atomics'], 1):.1f}x)")
            res.setdefault(kind, dict(args=args, active=active,
                                      kw=kw, g=(g_k, g_d), atomics=at))

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
                b6_args={kind: r["args"] for kind, r in res.items()},
                b6_atomics={kind: r["atomics"] for kind, r in res.items()})


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


def attn_train_path(torch, attn, data, lr=LR):
    """Forward and backward of NonLocalAttention `attn` into the video,
    the flows and the parameters, then SGD_STEPS steps of plain SGD of a
    copy of it towards the fixed target. Returns the gradients, the SGD
    updates (each parameter's sum over the steps of lr * grad: its change,
    without the rounding of p - lr * grad at |p|), the trained copy and
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
                u = lr * p.grad
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


def agg_cases(torch, dev, labels=None):
    """The cases of the aggregation checks and times (phases 8 and 10 and
    the variants scripts b8_b9_variants, b7_b10_variants): {label: ((vid,
    weights, offsets), ScatterAdd keywords, Pool keywords)}, or the ones
    of `labels`. The agg example's twin at 128^2 (its search's
    softmax(-10 d) weights and offsets: one live slot of eight, at the
    query's own pixel) and the same example at 512^2; agg_inputs' strided
    64^2 (ps 4, pool 5, pt 2, dilation 2, use_adj, strides 2, fills); and
    the twin's video and offsets with seeded uniform (0, 1] weights (every
    slot live, the destinations scattered). A label "agg example N^2" or
    "agg example dense N^2" gives the same at N^2."""
    from stnls_tpu_torch import agg_example
    from stnls_tpu_torch.search.utils import shape_vids
    a1 = dict(ps=3, pt=1, dilation=1, reflect_bounds=True, use_adj=False)
    a2 = dict(ps=4, pt=2, dilation=2, reflect_bounds=True, use_adj=True)
    one = (dict(a1, strideIn=1, strideOut=1), dict(a1, stride0=1))
    labels = labels or ("agg example 128^2", "strided 64^2",
                        "agg example 512^2", "agg example dense 128^2")
    out, searched = {}, {}
    for label in labels:
        if label == "strided 64^2":
            out[label] = (agg_inputs(torch, dev), dict(a2, strideIn=2,
                                                        strideOut=2),
                          dict(a2, stride0=2))
            continue
        size = int(re.search(r"(\d+)\^2", label).group(1))
        if size not in searched:
            cfg = dict(agg_example.CONFIG, H=size, W=size)
            a_in = agg_example.make_inputs(SEED, device=dev, **cfg)
            d, o = agg_example.search(*a_in, **cfg)
            searched[size] = (shape_vids(cfg["HD"], [a_in[0]])[0]
                              .contiguous(), d, o.contiguous())
            del a_in
        v6, d, o = searched[size]
        if "dense" in label:
            rng = np.random.default_rng(SEED + 8)
            w = torch.from_numpy((1. - rng.random(tuple(d.shape)))
                                 .astype(np.float32)).to(dev)
        else:
            w = torch.softmax(-10. * d, -1).contiguous()
        out[label] = ((v6, w, o),) + one
    return out


def sp_forward_bound(key, terms, vid, weights, flows, out):
    """The bound of B7 or B9 (key) with output `out`: inputs and output
    moved once, FLOPS_PER_TAP per (query, slot, step, tap, channel) of
    the `terms` with a live weight (agg_terms), and B9's division once
    per output element."""
    ops = terms * vid.shape[3] * FLOPS_PER_TAP[key]
    return bound_ms(nb(vid, weights, flows, out),
                    ops + (out.numel() if key == "B9" else 0))


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
    exactly 0; B9's output and B8's gradients bitwise equal on a second
    call. Returns the largest errors, the bounds from this run's data and
    the arguments of the timings."""
    from stnls_tpu_torch.ops import agg_sp_cuda as sp
    vid, weights, flows = inputs
    rng = np.random.default_rng(SEED + 6)
    F = vid.shape[3]

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
        if kf == "B9":
            with torch.no_grad():
                require(torch.equal(out, fwd(vid, weights, flows, **cfg)),
                        f"B9 {name}: two calls differ")
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
        again = bwd(*b_args)
        if kb == "B8":
            require(torch.equal(g_k[0], again[0]) and
                    torch.equal(g_k[1], again[1]),
                    f"B8 {name}: two calls differ")
            log(f"[agg] B8 and B9 {name}: bitwise equal on two calls")
        else:
            require(torch.equal(g_k[1], again[1]),
                    f"B10 {name}: g_weights differs on two calls")
            log(f"[agg] B10 {name}: g_weights bitwise equal on two calls")
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
        bounds[kf] = sp_forward_bound(kf, terms, vid, weights, flows, out)
        if kf == "B7":
            in_frame = agg_terms(torch, plain, vid, torch.ones_like(live),
                                 flows, cfg)
            bounds["B8"] = bound_ms(in_bytes + nb(g, *g_k[:2]),
                                    (terms + in_frame) * F
                                    * FLOPS_PER_TAP["B8"])
        else:
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
    inputs), (3, 16) (the same shape with one head of 16) and (1, 2) (the
    1080p alignment search's pair, on two heads of 2 at 256^2): each body
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
    p12 = make_inputs(torch, rng, dev, B=1, HD=2, T=5, F=2, H=256, W=256,
                      wt=2)
    pc = tuple(x.contiguous() for x in search_centres(
        p12[0].shape, p12[2], wt=2, stride0=1))
    cases = {(3, 8): (res["inputs"][:3], vres["b5_args"]),
             (3, 16): ((u0, u1, uflows), (u0, u1) + uc),
             (1, 2): (p12, p12[:2] + pc)}
    out = {}
    for pair, (b1_args, b5_args) in cases.items():
        calls = {}      # each returns a tuple of tensors
        b1_kw = dict(kw, ps=pair[0])
        if lib.stnls_nls_topk_compiled(*pair):
            calls["B1"] = lambda: nls_cuda.nls_topk(*b1_args, **b1_kw)
        if lib.stnls_nls_vol_compiled(*pair):
            calls["B5"] = lambda: (nls_vol_cuda.nls_volume(
                *b5_args, **dict(vkw, ps=pair[0])),)
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
    for name, c in ms.CONFIGS.items():
        if c["config"] == 6:        # the denoiser's train step: phase 15
            continue
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
        wanted = ["nls_topk_fwd", "nls_geometry_fwd"] + (
            ["nls_topk_bwd"] if cfg["backward"] else [])
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
    1e-4 * max|ref|, position gradients off the integer lattice; B2's
    time (CUDA events, wrapper included) and global atomics, summed over
    the heads, at least 2x fewer than the first version's. A float search
    (configs 5 and 7). Returns B2's largest error, its bound on these
    frames (bound_ms, summed over the heads) and dict(ms, atomics)."""
    from stnls_tpu_torch.attn_step import cuda_ms
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
    err2, n_off, b2_ms = 0., 0, 0.
    b2_bytes, b2_flops = 0, 0     # B2's bound, summed over the heads
    b2_at = dict(global_atomics=0, first_version=0, active_pairs=0)
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
        b2_args = (v, v, *pos, g_d, bwd_cfg)
        g_k = nls_cuda.nls_topk_bwd(*b2_args)
        nbytes, flops = b2_work(b2_args)
        b2_bytes, b2_flops = b2_bytes + nbytes, b2_flops + flops
        b2_ms += cuda_ms(lambda: nls_cuda.nls_topk_bwd(*b2_args), n=3,
                         warm=1)
        at = b2_atomics(torch, b2_args)
        for key in b2_at:
            b2_at[key] += at[key]
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
        del d_k, c_k, geo, pos, g_d, g_k, g_p, off, b2_args
    b2_bound = bound_ms(b2_bytes, b2_flops)
    b2_at["fewer"] = b2_at["first_version"] / max(b2_at["global_atomics"], 1)
    require(b2_at["fewer"] >= 2, f"B2 {name}: fewer than 2x fewer global "
            "atomics than the first version")
    log(f"[matrix] {name} at the full {H}x{W}, {HD} heads: B1 dists and "
        f"cells equal to the plain volume's bitwise ({rows}-row bands); B2 "
        f"on a seeded cotangent max|kernel-plain| {err2:.3e} (plain over "
        f"{frames}-frame chunks; position gradients compared at {n_off} of "
        f"{B * HD * T * H * W * K} (query, slot)); B2's bound on these "
        f"frames {b2_bound[0]:.4f} ms by {b2_bound[1]}")
    log(f"[matrix] {name} at the full {H}x{W}: B2 {b2_ms:.3f} ms over the "
        f"{HD} heads (previous design {EARLIER_MS['B2 config 7 device']} "
        f"device ms in the step's trace; bound {b2_bound[0]:.4f}); global "
        f"atomics per backward {b2_at['global_atomics']} for "
        f"{b2_at['active_pairs']} active (q, k), the first version's "
        f"{b2_at['first_version']} ({b2_at['fewer']:.2f}x more)")
    return err2, b2_bound, dict(ms=b2_ms, atomics=b2_at)


def b2_config4_phase(torch, smi_line, matrix, name="gda540p_ws9"):
    """B2 on config 4's whole frames (540x960, (ps, F) = (1, 16), no
    flows) on a seeded cotangent at B1's cells: against its plain
    version at 1e-4 * max|ref| (position gradients off the integer
    lattice), its time (CUDA events, wrapper included), bound and global
    atomics, and its launches a step (the matrix phase's run). Returns
    dict(ms, bound_ms, bound_by, launches, atomics, err)."""
    from stnls_tpu_torch import matrix_steps as ms
    from stnls_tpu_torch.attn_step import cuda_ms
    from stnls_tpu_torch.ops import nls_cuda
    from stnls_tpu_torch.ops.nls_k import cells_geometry
    cfg = ms.config(name)
    v, fl = matrix_search_args(torch, cfg, matrix[name][1])
    H, W = v.shape[-2:]
    with torch.no_grad():
        _, cells = nls_cuda.nls_topk(v, v, fl, ws=cfg["ws"], wt=cfg["wt"],
                                     ps=cfg["ps"], stride0=1, stride1=1,
                                     k=cfg["K"], anchor=True)
    geo = cells_geometry(fl, cells, H=H, W=W, ws=cfg["ws"], wt=cfg["wt"],
                         stride0=1, stride1=1)
    gen = torch.Generator(device=v.device).manual_seed(SEED + 4)
    g_d = torch.randn(tuple(cells.shape), generator=gen, device=v.device)
    args = (v, v, geo["prop_h"], geo["prop_w"], geo["tj_k"], geo["valid"],
            g_d, dict(ps=cfg["ps"], stride0=1, dist_type="l2", dilation=1,
                      use_adj=False, itype=cfg["itype"]))
    g_k = nls_cuda.nls_topk_bwd(*args)
    g_p = nls_cuda.nls_topk_bwd_plain(*args)
    # without flows every position lies on the integer lattice, where the
    # position gradients jump: they are compared off it only, if anywhere
    off = off_integer(geo["prop_h"]) & off_integer(geo["prop_w"])
    err = max(grad_close(gk if m is None else gk[m],
                         gp if m is None else gp[m],
                         f"B2 {name} {what}")[0]
              for gk, gp, what, m in zip(g_k, g_p, ("g_vid0", "g_vid1",
                                                    "g_prop_h", "g_prop_w"),
                                         (None, None, off, off))
              if m is None or bool(m.any()))
    del g_k, g_p
    t = cuda_ms(lambda: nls_cuda.nls_topk_bwd(*args), n=5, warm=1)
    bound = bound_ms(*b2_work(args))
    at = b2_atomics(torch, args)
    launches = matrix[name][2]["nls_topk_bwd"]
    log(f"[times] {smi_line}: B2 on config 4's {H}x{W} frames (1, "
        f"{v.shape[3]}) {t:.3f} ms (previous design "
        f"{EARLIER_MS['B2 config 4 device']} device ms in the step's "
        f"trace), bound {bound[0]:.4f} by {bound[1]}, {launches} launch(es) "
        f"a step; max|kernel-plain| {err:.3e}; global atomics per backward "
        f"{at['global_atomics']} for {at['active_pairs']} active (q, k), "
        f"the first version's {at['first_version']} ({at['fewer']:.2f}x "
        "more)")
    return dict(ms=t, bound_ms=bound[0], bound_by=bound[1],
                launches=launches, atomics=at, err=err)


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
        # B1's bound at the full size: every cell of every window (full_ws
        # keeps the windows in the frame), outputs of K slots
        Bf, HDf, Tf, Ff, Hf, Wf = v.shape
        nq, W_t = Bf * HDf * Tf * Hf * Wf, min(2 * cfg["wt"] + 1, Tf)
        full_bound = bound_ms(nb(v, v, fl) + 2 * 4 * nq * cfg["K"],
                              nq * W_t * cfg["ws"] ** 2 * Ff
                              * FLOPS_PER_TAP["B1"])
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
        out[label]["B1"]["full_size_bound_ms"] = full_bound[0]
        out[label]["B1"]["full_size_bound_by"] = full_bound[1]
        # W_t = 1 at (1, 16): every centre is its query's pixel, where B5
        # and B6 run slower than their previous design (PERF.md section 7)
        log(f"[times] {smi_line}: (ps, F) = ({label}) at "
            f"{MATRIX_CROP[0]}x{MATRIX_CROP[1]} of {name}, W_t = "
            f"{min(2 * cfg['wt'] + 1, cfg['T'])}: " + "; ".join(
                f"{key} {t[key][0]:.3f} ms ("
                + (f"previous design {EARLIER_MS[f'{key} {label}']}, this "
                   f"run {t[key][0] / EARLIER_MS[f'{key} {label}']:.2f}x it; "
                   if f"{key} {label}" in EARLIER_MS else "")
                + f"plain {t[key][1]:.3f}, bound {bounds[key][0]:.4f} by "
                f"{bounds[key][1]})" for key in t)
            + f"; B1 at {tuple(full[0].shape[-2:])} {t_full:.3f} ms (bound "
            f"{full_bound[0]:.4f} by {full_bound[1]})")
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
            f"{key} {ms:.3f} ms ("
            + (f"previous design {EARLIER_MS[f'{key} chunk']}; "
               if f"{key} chunk" in EARLIER_MS else "")
            + f"plain {pms:.3f}, bound {bounds[key][0]:.4f} by "
            f"{bounds[key][1]})" for key, (ms, pms) in t.items()))
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
            and launches["nls_geometry_fwd"] == launches["nls_topk_fwd"]
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
    # B3 at the arguments of the step's gather (halo frames included)
    from stnls_tpu_torch.ops import agg_cuda
    calls = []
    apply = agg_cuda._GatherStack.apply
    agg_cuda._GatherStack.apply = lambda *a: (calls.append(a), apply(*a))[1]
    try:
        run(1)
    finally:
        del agg_cuda._GatherStack.apply
    vid_g, w_g, fl_g, cfg_g = calls[0]
    with torch.no_grad():
        t_b3 = cuda_ms(lambda: agg_cuda.nl_gather_stack(vid_g, w_g, fl_g,
                                                        **cfg_g))
    b3 = bound_ms(*b3_work(vid_g, w_g, fl_g, cfg_g["ps"], cfg_g["stride0"]))
    log(f"[times] {smi_line}: B3 at the twin's gather, video "
        f"{tuple(vid_g.shape)}, {len(calls)} launch(es) a step: {t_b3:.3f} "
        f"ms (previous design {EARLIER_MS['B3 multichip twin device']} "
        f"device ms a step in its trace), bound {b3[0]:.4f} by {b3[1]}")
    del calls, vid_g, w_g, fl_g
    log(f"[twin] dryrun_multichip's step at the widths {widths}, "
        f"B = {vid.shape[0]}, T = {vid.shape[1]}, one-rank mesh: launches "
        f"{launches}; losses {losses} (plain route "
        f"{[float(x[0]) for x in ref_hist]}); max|kernels-plain| "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    log(f"[times] {smi_line}: twin train step {t:.3f} ms")
    return dict(launches=launches, err=max(errs.values()), ms=t,
                losses=losses, b3=dict(ms=t_b3, bound_ms=b3[0],
                                       bound_by=b3[1]))


# 15. the model layer: matrix config 6 (the NonLocalDenoiser train step)
# at its published 540x960 through B1-B4, and against the plain route on
# DENOISER_CROP of its inputs (the plain B1/B2/B4 stay within seconds
# there); the stack attention and StackConv at the slice's widths; vnlb on
# a seeded noisy video of VNLB_SIZE through B1
DENOISER = "denoiser540p_train_step"
DENOISER_CROP = (270, 480)
STACK_CONV_AGG = {"agg_name": "stack_conv", "embed_dim": 8, "nheads": 2,
                  "inner_mult": 1, "k_agg": 10}
# the SGD rate of the stack modules: their stack projections see K = 10
# patches a pixel, and at LR the seeded modules' losses grow
STACK_LR = 0.02
VNLB_CFG = {"sigma": 30., "ws": 7, "wt": 1, "ps": 5, "k": 24, "stride0": 2,
            "nsteps": 2}
VNLB_SIZE = dict(B=1, T=5, H=128, W=128)
# the content of the vnlb video moves by (dh, dw) pixels a frame
VNLB_MOTION = (1., 2.)


def denoiser_train(torch, inputs, steps=SGD_STEPS):
    """Config 6's step (matrix_steps, parameters seeded SEED + 6) on
    `inputs`, then `steps` steps of plain SGD of its denoiser towards the
    clean video. Returns the first step's result, each parameter's change
    over the SGD steps (the sum of LR * grad), the losses and the step."""
    from stnls_tpu_torch import matrix_steps as ms
    step = ms.make_step(DENOISER, seed=SEED + 6)
    res = step(*inputs)
    updates = {n: torch.zeros_like(p)
               for n, p in step.model.named_parameters()}
    losses, cur = [], res
    for i in range(steps):
        losses.append(float(cur["loss"]))
        with torch.no_grad():
            for n, p in step.model.named_parameters():
                u = LR * cur["grads"][n]
                p -= u
                updates[n] += u
        if i + 1 < steps:
            cur = step(*inputs)
    losses.append(float(step(*inputs)["loss"]))
    return res, updates, losses, step


def denoiser_search(torch, model, inputs):
    """The (dists, offsets) of the denoiser's attention search on the
    route in force."""
    from stnls_tpu_torch.nn.utils import rescale_flows
    from stnls_tpu_torch.utils.config import ConfigDict
    noisy, _, fflow, bflow = inputs
    B, T, C, H, W = noisy.shape
    with torch.no_grad():
        x = model.embed(noisy.reshape(B * T, C, H, W)).reshape(B, T, -1, H,
                                                               W)
        fl = rescale_flows(ConfigDict(fflow=fflow, bflow=bflow), H, W)
        q, k, _ = model.attn.get_qkv(x)
        return model.attn.search(q, k, fl.fflow, fl.bflow)


@contextlib.contextmanager
def captured_kernel_args(calls):
    """Record into `calls` (name -> list) the arguments of each call of
    B1-B4 and G1 while inside: nls_topk's (args, kwargs, result), B2's and
    B4's argument tuples (from their autograd Functions' backward), B3's
    (vid, weights, flows, cfg), nls_geometry's (flows, cells, kwargs). The
    wrappers and their launch counts are not touched."""
    from stnls_tpu_torch.search import non_local_search
    from stnls_tpu_torch.ops import nls_cuda, agg_cuda
    b1_fn = non_local_search.nls_topk
    g1_fn = non_local_search.nls_geometry
    b2_fn = nls_cuda._SearchDists.__dict__["backward"]
    b4_fn = agg_cuda._GatherStack.__dict__["backward"]
    apply = agg_cuda._GatherStack.apply

    def b1(*args, **kw):
        out = b1_fn(*args, **kw)
        calls.setdefault("B1", []).append((args, kw, out))
        return out

    def g1(flows, cells, **kw):
        calls.setdefault("G1", []).append((flows.detach(), cells, kw))
        return g1_fn(flows, cells, **kw)

    def b2(ctx, g_d):
        calls.setdefault("B2", []).append(
            (*ctx.saved_tensors, g_d, ctx.cfg) + tuple(ctx.chunk))
        return b2_fn.__func__(ctx, g_d)

    def b3(*args):
        calls.setdefault("B3", []).append(args)
        return apply(*args)

    def b4(ctx, g_stack):
        calls.setdefault("B4", []).append(
            (*ctx.saved_tensors, g_stack, ctx.cfg, ctx.needs_input_grad[:3]))
        return b4_fn.__func__(ctx, g_stack)

    non_local_search.nls_topk = b1
    non_local_search.nls_geometry = g1
    nls_cuda._SearchDists.backward = staticmethod(b2)
    agg_cuda._GatherStack.apply = b3
    agg_cuda._GatherStack.backward = staticmethod(b4)
    try:
        yield calls
    finally:
        non_local_search.nls_topk = b1_fn
        non_local_search.nls_geometry = g1_fn
        nls_cuda._SearchDists.backward = b2_fn
        agg_cuda._GatherStack.backward = b4_fn
        del agg_cuda._GatherStack.apply


def config6_kernels(torch, smi_line, inputs):
    """B1-B4 at the arguments config 6's step gives them: one call each a
    step, their CUDA-event times and their bounds."""
    from stnls_tpu_torch import matrix_steps as ms
    from stnls_tpu_torch.attn_step import cuda_ms
    from stnls_tpu_torch.ops import nls_cuda, agg_cuda
    step = ms.make_step(DENOISER, seed=SEED + 6)
    calls = {}
    with captured_kernel_args(calls):
        step(*inputs)
    require({k: len(v) for k, v in calls.items()} ==
            {"B1": 1, "B2": 1, "B3": 1, "B4": 1, "G1": 1},
            f"config 6: kernel calls a step {calls.keys()}")
    (a1, kw1, (d1, c1)), = calls["B1"]
    a2, = calls["B2"]
    a3, = calls["B3"]
    a4, = calls["B4"]
    cfg = ms.config(DENOISER)
    bounds = {"B1": bound_ms(*b1_work(*a1, d1, c1, ws=kw1["ws"],
                                      wt=kw1["wt"], ps=kw1["ps"])),
              "B2": bound_ms(*b2_work(a2)),
              "B3": bound_ms(*b3_work(*a3[:3], a3[3]["ps"],
                                      a3[3]["stride0"])),
              "B4": bound_ms(*b4_work(a4))}
    with torch.no_grad():
        t = {"B1": cuda_ms(lambda: nls_cuda.nls_topk(*a1, **kw1), n=5),
             "B2": cuda_ms(lambda: nls_cuda.nls_topk_bwd(*a2), n=5),
             "B3": cuda_ms(lambda: agg_cuda.nl_gather_stack(
                 *a3[:3], **a3[3]), n=5),
             "B4": cuda_ms(lambda: agg_cuda.nl_gather_stack_bwd(*a4), n=5)}
    log(f"[times] {smi_line}: config 6 at {cfg['H']}x{cfg['W']}, video "
        f"{tuple(a1[0].shape)}, K {c1.shape[-1]}: " + "; ".join(
            f"{key} {t[key]:.3f} ms (bound {bounds[key][0]:.4f} by "
            f"{bounds[key][1]})" for key in t))
    return {key: dict(ms=t[key], bound_ms=bounds[key][0],
                      bound_by=bounds[key][1]) for key in t}


def denoiser_phase(torch, dev, smi_line):
    """(1) config 6 at its published size through the kernels: one step
    (B1-B4 launched once each, no plain backward), outputs and every
    parameter's gradient finite and non-zero, then SGD_STEPS SGD steps
    that lower the loss; its median time and peak memory. (2) on
    DENOISER_CROP of the inputs, the kernel route against the plain
    backwards on the kernels' forward and against plain_route(): the
    output at TOL (away from the reach of a query whose cells flipped at a
    near-tie), the loss at TOL, the gradients and each parameter's SGD
    update under compare()'s rules. Returns the launches, the errors, the
    times and the kernels' rows at config 6."""
    from stnls_tpu_torch import matrix_steps as ms
    from stnls_tpu_torch.attn_step import cuda_ms
    cfg = ms.config(DENOISER)
    inputs = ms.make_inputs(DENOISER, SEED, device=dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    reset_counts()
    step = ms.make_step(DENOISER, seed=SEED + 6)
    res = step(*inputs)
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated(dev) - base) / 1e9
    launches, plain_calls = read_counts()
    log(f"[denoiser] config 6 at {cfg['H']}x{cfg['W']}, T {cfg['T']}: "
        f"launches {launches}, plain backward calls {plain_calls}, peak "
        f"{peak:.3f} GB")
    one_each = ("nls_topk_fwd", "nls_topk_bwd", "nls_geometry_fwd",
                "agg_gather_fwd", "agg_gather_bwd")
    require(all(launches[k] == 1 for k in one_each) and
            not any(v for k, v in launches.items() if k not in one_each),
            f"config 6: launches a step {launches}, not one each of B1-B4 "
            "and G1")
    require(not any(plain_calls.values()),
            "config 6: a plain backward ran on the kernel route")
    require(tuple(res["out"].shape) == tuple(inputs[0].shape) and
            bool(res["out"].isfinite().all()), "config 6: output")
    for name, g in res["grads"].items():
        require(bool(g.isfinite().all()) and float(g.abs().max()) > 0,
                f"config 6: the gradient of {name} is not finite or is 0")
    _, updates, losses, _ = denoiser_train(torch, inputs)
    require(losses[-1] < losses[0], f"config 6: SGD losses {losses}")
    log(f"[denoiser] config 6: loss {float(res['loss']):.6f}, every "
        f"gradient of {len(res['grads'])} parameters finite and non-zero; "
        f"{SGD_STEPS} SGD steps, losses {losses}")
    t = cuda_ms(lambda: step(*inputs), n=5, warm=1)
    log(f"[times] {smi_line}: config 6 train step {t:.3f} ms = "
        f"{cfg['T'] / (t / 1e3):.2f} frames/s (peak {peak:.3f} GB)")
    rows = config6_kernels(torch, smi_line, inputs)
    del res, updates, step

    # (2) the crop, through the kernels and the plain routes
    crop = crop_inputs(inputs, *DENOISER_CROP)
    mine, upd, losses, step_k = denoiser_train(torch, crop)
    with plain_route(forward=False):
        bwd, bwd_upd, _, step_b = denoiser_train(torch, crop)
    with plain_route():
        ref, ref_upd, ref_losses, step_p = denoiser_train(torch, crop)
    geo = dict(wt=cfg["wt"], ps=cfg["ps"])
    fresh = ms.make_step(DENOISER, seed=SEED + 6).model.to(dev)
    ours = denoiser_search(torch, fresh, crop)
    with plain_route():
        theirs = denoiser_search(torch, fresh, crop)
    reach_ps = cfg["ps"] + 2 * (2 * cfg["nres"] + 1)    # + the 3x3 convs
    mask, n_flip = flipped_reach(torch, tuple(mine["out"].shape), ours,
                                 theirs, output=True, wt=0, ps=reach_ps)
    err_out = close(mine["out"].masked_fill(mask, 0.),
                    ref["out"].masked_fill(mask, 0.),
                    "config 6 output kernels vs plain")
    close(mine["loss"], ref["loss"], "config 6 loss kernels vs plain")
    errs = {"out": err_out}
    for name, g in mine["grads"].items():
        errs[f"grad {name}"], _ = grad_close(
            g, bwd["grads"][name], f"config 6 grad {name} vs the plain "
            "backwards on the kernels' forward")
        err, _ = compare(torch, g, ref["grads"][name],
                         f"config 6 grad {name} vs the plain route",
                         lambda: (ours, theirs), **geo)
        errs[f"grad {name}"] = max(errs[f"grad {name}"], err)
    trained = denoiser_search(torch, step_k.model, crop)
    with plain_route():
        trained_ref = denoiser_search(torch, step_p.model, crop)
    trained_bwd = denoiser_search(torch, step_b.model, crop)
    for name, u in upd.items():
        err, scale = compare(torch, u, ref_upd[name], f"config 6 SGD update "
                             f"of {name} vs the plain route",
                             lambda: (trained, trained_ref), **geo)
        err_b, _ = compare(torch, u, bwd_upd[name], f"config 6 SGD update "
                           f"of {name} vs the plain backwards",
                           lambda: (trained, trained_bwd), **geo)
        require(scale > 0, f"config 6: SGD left {name} unchanged")
        errs[f"update {name}"] = max(err, err_b)
    log(f"[denoiser] config 6 on the {DENOISER_CROP[0]}x{DENOISER_CROP[1]} "
        f"crop vs the plain route: output max|kernels-plain| {err_out:.3e} "
        f"away from {n_flip} queries that took other cells at a near-tie; "
        f"SGD losses, kernels {losses}, plain {ref_losses}; largest "
        "max|kernels-plain| of the gradients "
        f"{max(v for k, v in errs.items() if k.startswith('grad')):.3e}, "
        "of the SGD updates "
        f"{max(v for k, v in errs.items() if k.startswith('update')):.3e}")
    return dict(launches=launches, ms=t, peak_gb=peak, rows=rows,
                err=max(v for k, v in errs.items() if k != "out"),
                err_out=err_out)


def stack_phase(torch, dev, smi_line, data, step):
    """NonLocalAttentionStack (the gather stack) and NonLocalAttention
    with StackConv (STACK_CONV_AGG) at the slice's widths and search:
    the forward through the kernels against plain_route() at TOL, then the
    training path of phase 5 (attn_train_path: gradients into the video,
    the flows and the parameters, SGD_STEPS SGD steps at STACK_LR) through
    check_routes. Returns each module's launches and fwd+bwd time."""
    from stnls_tpu_torch.attn_step import attention_module, cuda_ms
    from stnls_tpu_torch.nn import NonLocalAttentionStack
    from stnls_tpu_torch.utils.config import ConfigDict
    vid, fflow, bflow = data[:3]
    flows = ConfigDict(fflow=fflow, bflow=bflow)
    out = {}
    for label, module in (
            ("stack", attention_module(SEED + 1, dev,
                                       cls=NonLocalAttentionStack)),
            ("stack_conv", attention_module(SEED + 1, dev,
                                            agg=STACK_CONV_AGG))):
        reset_counts()
        with torch.no_grad():
            y, _ = module(vid, flows)
        torch.cuda.synchronize()
        fwd = read_counts()[0]
        with torch.no_grad(), plain_route():
            y_ref, _ = module(vid, flows)
        require(tuple(y.shape) == tuple(vid.shape) and
                bool(y.isfinite().all()), f"{label}: output")
        err = close(y, y_ref, f"{label} forward kernels vs plain")
        log(f"[{label}] forward launches {fwd}; out {tuple(y.shape)}, "
            f"max|kernels-plain| {err:.3e}")
        require(fwd["nls_topk_fwd"] == 1 and fwd["agg_gather_fwd"] == 1,
                f"{label}: the forward did not run B1 and B3")
        launches = check_routes(
            torch, label, lambda m=module: attn_train_path(torch, m, data,
                                                           lr=STACK_LR),
            ("nls_topk_fwd", "nls_topk_bwd", "nls_geometry_fwd",
             "nls_geometry_bwd", "agg_gather_fwd", "agg_gather_bwd"),
            module, step, data,
            dict(wt=step.search.wt, ps=step.search.ps))

        def fwd_bwd(m=module):
            v = vid.clone().requires_grad_()
            o, _ = m(v, flows)
            torch.autograd.grad(o.pow(2).mean(), [v] + list(m.parameters()))

        t = cuda_ms(fwd_bwd)
        log(f"[times] {smi_line}: {label} fwd+bwd {t:.3f} ms = "
            f"{vid.shape[1] / (t / 1e3):.2f} frames/s")
        out[label] = dict(launches=launches, fwd_bwd_ms=t, err=err)
    return out


def vnlb_video(torch, dev, rng, *, B, T, H, W):
    """A smooth RGB video in [0, 1] whose content moves by VNLB_MOTION a
    frame (low-frequency sinusoids of numpy seed draws), its noisy copy
    (sigma 30 / 255) and the flows of that motion (fflow (dw, dh), bflow
    the negation)."""
    dh, dw = VNLB_MOTION
    t = np.arange(T)[:, None, None]
    y = np.arange(H)[None, :, None] - dh * t
    x = np.arange(W)[None, None, :] - dw * t
    clean = np.zeros((B, T, 3, H, W))
    for b in range(B):
        for c in range(3):
            f = np.zeros((T, H, W))
            for _ in range(4):
                ky, kx = rng.uniform(0.02, 0.12, 2)
                f += rng.uniform(0.5, 1.) * np.sin(ky * y + kx * x
                                                   + rng.uniform(0, 6.3))
            clean[b, :, c] = 0.5 + 0.12 * f
    clean = np.clip(clean, 0., 1.).astype(np.float32)
    noisy = clean + (VNLB_CFG["sigma"] / 255.) * rng.standard_normal(
        clean.shape).astype(np.float32)
    fflow = np.zeros((B, T, 2, H, W), np.float32)
    fflow[:, :, 0], fflow[:, :, 1] = dw, dh
    return tuple(torch.from_numpy(a).to(dev) for a in (clean, noisy, fflow,
                                                      -fflow))


def vnlb_phase(torch, dev, smi_line):
    """vnlb (run_vnlb at VNLB_CFG, int search through B1) on a seeded
    video of VNLB_SIZE: the time of a call and of its Bayes filter
    (batched torch.linalg.eigh); its search's offsets equal
    plain_route()'s, the output at TOL against plain_route()'s (the rest
    of the pipeline is deterministic), the PSNR gain; and
    flow_patches.get_mse, the true motion scoring below zero flow."""
    from stnls_tpu_torch.attn_step import cuda_ms
    from stnls_tpu_torch.misc import vnlb, flow_patches
    from stnls_tpu_torch.search.non_local_search import NonLocalSearch
    from stnls_tpu_torch.utils.color import rgb2yuv
    from stnls_tpu_torch.utils.config import ConfigDict
    rng = np.random.default_rng(SEED + 7)
    clean, noisy, fflow, bflow = vnlb_video(torch, dev, rng, **VNLB_SIZE)
    cfg = VNLB_CFG
    # one call each: its batched eigh takes seconds (the times of the
    # kernel route's call, which also counts the launches)
    reset_counts()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    out = vnlb.run_vnlb(cfg, noisy)
    end.record()
    end.synchronize()
    t_all = start.elapsed_time(end)
    launches = read_counts()[0]
    require(launches["nls_topk_fwd"] == cfg["nsteps"] and
            launches["nls_geometry_fwd"] == cfg["nsteps"] and
            sum(launches.values()) == 2 * cfg["nsteps"],
            f"vnlb: launches {launches}, not one B1 and one G1 a step")
    search = NonLocalSearch(cfg["ws"], cfg["wt"], cfg["ps"], cfg["k"],
                            stride0=cfg["stride0"], self_action="anchor",
                            itype="int")
    yuv = rgb2yuv(noisy)
    d_k, i_k = search(yuv, yuv)
    groups = vnlb._gather_groups(yuv, i_k, cfg["ps"], cfg["stride0"])
    t_filter = cuda_ms(lambda: vnlb._bayes_filter(groups, cfg["sigma"]),
                       n=1, warm=0)
    log(f"[times] {smi_line}: vnlb on {tuple(noisy.shape)} {t_all:.3f} ms "
        f"a call ({cfg['nsteps']} steps), its Bayes filter {t_filter:.3f} "
        f"ms a step (batched eigh of {groups[..., 0, 0].numel()} "
        f"{groups.shape[-1]}x{groups.shape[-1]} covariances)")
    with plain_route():
        ref = vnlb.run_vnlb(cfg, noisy)
        d_p, i_p = search(yuv, yuv)
    require(torch.equal(i_k, i_p), "vnlb: B1's offsets differ from the "
            "plain version's")
    err_d = close(d_k, d_p, "vnlb search dists")
    err = close(out, ref, "vnlb output kernels vs plain")

    def psnr(a):
        return float(10 * torch.log10(1. / ((a - clean) ** 2).mean()))

    p_in, p_out = psnr(noisy), psnr(out)
    require(bool(out.isfinite().all()) and p_out > p_in + 4.,
            f"vnlb: PSNR {p_in:.2f} -> {p_out:.2f} dB")
    zero = ConfigDict(fflow=torch.zeros_like(fflow),
                      bflow=torch.zeros_like(bflow))
    mse_true = flow_patches.get_mse(clean, ConfigDict(fflow=fflow,
                                                      bflow=bflow), 3)
    mse_zero = flow_patches.get_mse(clean, zero, 3)
    require(all(np.isfinite(v) for v in (*mse_true.values(),
                                        *mse_zero.values())) and
            mse_true.fflow < mse_zero.fflow and
            mse_true.bflow < mse_zero.bflow,
            f"flow_patches: true motion {mse_true}, zero {mse_zero}")
    log(f"[vnlb] video {tuple(noisy.shape)}, {cfg}: launches {launches}; "
        f"offsets equal to the plain route's, dists max|kernels-plain| "
        f"{err_d:.3e}; output max|kernels-plain| {err:.3e}; PSNR "
        f"{p_in:.3f} -> {p_out:.3f} dB; groups {tuple(groups.shape)}")
    log(f"[vnlb] flow_patches.get_mse, true motion {dict(mse_true)}, zero "
        f"flow {dict(mse_zero)}")
    return dict(launches=launches, ms=t_all, bayes_filter_ms=t_filter,
                psnr_in=p_in, psnr_out=p_out, err=max(err, err_d),
                size=dict(VNLB_SIZE), flow_mse=dict(
                    true=dict(mse_true), zero=dict(mse_zero)))


# Phase 16: the twin of benchmarks/search_bench.py
# (stnls_tpu_torch/search_bench.py) at its full size, SB_REPS calls a
# search after one warm-up (the twin's own default is the original's 5:
# at 2 the phase stays near two minutes, its refine a plain lattice of
# ~8 s a call); B1 and B2 at its (ps 7, F 9, ws 21, W_t 3) on
# an SB_CROP^2 crop of its inputs; the refine on an SB_REFINE_CROP^2 crop
# (its selection in SB_REFINE_BANDS bands) against the whole plain
# lattice; the other flavours at SB_SMALL^2 on the card against the CPU
SB_REPS = 2
SB_CROP, SB_REFINE_CROP, SB_REFINE_BANDS, SB_SMALL = 96, 32, 8, 16
# the refine crop's given offsets are the crop search's, moved off the
# integers so that the position derivatives are the bilinear weights'
SB_FRACTION = 0.3


def search_bench_run(torch, dev, smi_line):
    """The search_bench twin's sequence at full size through the kernels,
    counts set to 0 just before and read just after: one B1 launch a
    NonLocalSearch call, one B2 launch a refine backward, no plain
    backward; outputs' shapes, finiteness, the anchored slot 0 of the
    search and the refine's ascending dists."""
    from stnls_tpu_torch import search_bench
    torch.cuda.empty_cache()
    reset_counts()
    res = search_bench.run(device=dev, reps=SB_REPS,
                           log=lambda line: log(f"[search_bench] "
                                                f"{smi_line}: {line}"))
    torch.cuda.synchronize()
    launches, plain = read_counts()
    calls = SB_REPS + 1
    for name in ("nls", "nls_int"):
        require(res[name]["b1"] == calls and res[name]["b2"] == 0,
                f"search_bench {name}: B1/B2 launches {res[name]['b1']}/"
                f"{res[name]['b2']} in {calls} calls")
    require(res["refine"]["b1"] == 0 and res["refine"]["b2"] == 0,
            "search_bench refine: its forward launched B1 or B2")
    require(res["refine fwd+bwd"]["b2"] == calls,
            f"search_bench refine: {res['refine fwd+bwd']['b2']} B2 "
            f"launches in {calls} backwards")
    # the sequence's own search for the refine's offsets is one more B1
    require(launches["nls_topk_fwd"] == 2 * calls + 1 and
            launches["nls_geometry_fwd"] == 2 * calls + 1 and
            launches["nls_topk_bwd"] == calls and
            not any(plain.values()),
            f"search_bench: launches {launches}, plain calls {plain}")
    data = res["data"]
    cfg, given, d, i = data["cfg"], data["given"], data["dists"], data["inds"]
    shape = (cfg["B"], cfg["HD"], cfg["T"], cfg["H"], cfg["W"], cfg["k"])
    require(tuple(given.shape) == shape + (3,) and
            bool((given[..., 0, :] == 0).all()),
            "search_bench nls: shape or anchored slot 0")
    require(tuple(d.shape) == shape and tuple(i.shape) == shape + (3,) and
            bool(d.isfinite().all()) and
            bool((d[..., 1:] >= d[..., :-1]).all()),
            "search_bench refine: shape, finite or ascending dists")
    log(f"[search_bench] launches {launches}: B1 once a NonLocalSearch "
        f"call, B2 once a refine backward ({SB_REPS} calls after one "
        "warm-up each)")
    return res, launches


def search_bench_kernel_args(torch, res):
    """B1's arguments at the twin's search (the videos [B,HD,T,F,H,W],
    the flows, its keywords) and B2's at the refine's winners (their key
    positions and frames from the refine's offsets, valid where its dists
    are finite) with the fwd+bwd line's cotangent (1 at every finite
    dist)."""
    from stnls_tpu_torch.search.utils import shape_vids, shape_flows
    data = res["data"]
    cfg = data["cfg"]
    v6 = shape_vids(cfg["HD"], [data["vid"]])[0].contiguous()
    fl7 = shape_flows(cfg["HD"], data["flows"]).contiguous()
    b1_kw = dict(ws=cfg["ws"], wt=cfg["wt"], ps=cfg["ps"], stride0=1,
                 stride1=1, k=cfg["k"], anchor=True, dist_type="l2")
    d, inds = data["dists"], data["inds"]
    dev = d.device
    grid = torch.arange(cfg["H"], device=dev, dtype=torch.float32)
    t = torch.arange(cfg["T"], device=dev)[:, None, None, None]
    valid = d.isfinite()
    b2_args = (v6, v6, (inds[..., 1] + grid[:, None, None]).contiguous(),
               (inds[..., 2] + grid[:, None]).contiguous(),
               t + inds[..., 0].long(), valid, valid.float(),
               dict(ps=cfg["ps"], stride0=1, dist_type="l2", dilation=1,
                    use_adj=False, itype="float"))
    return v6, fl7, b1_kw, b2_args


def search_bench_crop(torch, v6, fl7, b1_kw):
    """B1 (float and int, bitwise) and B2 (seeded cotangent, 1e-4 *
    max|ref|; position gradients off integers) against their plain
    versions at the twin's (ps, F, ws, W_t) on an SB_CROP^2 crop of its
    inputs, all heads and frames (B1's plain volume a head at a time).
    Returns the errors, times and bounds."""
    from stnls_tpu_torch.ops import nls_cuda
    from stnls_tpu_torch.ops.nls_k import cells_geometry
    from stnls_tpu_torch.attn_step import cuda_ms
    v = v6[..., :SB_CROP, :SB_CROP].contiguous()
    fl = fl7[..., :SB_CROP, :SB_CROP].contiguous()
    out = {}
    for itype in ("float", "int"):
        kw = dict(b1_kw, itype=itype)
        with torch.no_grad():
            d_k, c_k = nls_cuda.nls_topk(v, v, fl, **kw)
            torch.cuda.synchronize()
            for h in range(v.shape[1]):
                vh = v[:, h:h + 1]
                d_p, c_p = nls_cuda.nls_topk_plain(vh, vh, fl, **kw)
                require(torch.equal(d_k[:, h:h + 1], d_p) and
                        torch.equal(c_k[:, h:h + 1], c_p),
                        f"B1 search_bench crop {itype} head {h}: differs "
                        "from the plain volume's")
                del d_p, c_p
            out[f"B1 {itype} ms"] = cuda_ms(
                lambda: nls_cuda.nls_topk(v, v, fl, **kw), n=5, warm=1)
            vh = v[:, :1]
            out[f"B1 {itype} plain ms (a head)"] = cuda_ms(
                lambda: nls_cuda.nls_topk_plain(vh, vh, fl, **kw), n=1,
                warm=0)
        if itype == "float":
            out["B1 bound"] = bound_ms(*b1_work(v, v, fl, d_k, c_k,
                                                ws=kw["ws"], wt=kw["wt"],
                                                ps=kw["ps"]))
            cells = c_k
    log(f"[search_bench] B1 at (ps, F, ws, W_t) = ({b1_kw['ps']}, "
        f"{v.shape[3]}, {b1_kw['ws']}, {min(2 * b1_kw['wt'] + 1, v.shape[2])})"
        f" on the {SB_CROP}^2 crop, float and int: dists and cells equal "
        "to the plain volume's bitwise, head by head")
    H = W = SB_CROP
    geo = cells_geometry(fl, cells, H=H, W=W, ws=b1_kw["ws"],
                         wt=b1_kw["wt"], stride0=1, stride1=1)
    rng = np.random.default_rng(SEED + 16)
    g_d = torch.from_numpy(rng.standard_normal(tuple(cells.shape))
                           .astype(np.float32)).to(v.device)
    args = (v, v, geo["prop_h"], geo["prop_w"], geo["tj_k"], geo["valid"],
            g_d, dict(ps=b1_kw["ps"], stride0=1, dist_type="l2", dilation=1,
                      use_adj=False, itype="float"))
    g_k = nls_cuda.nls_topk_bwd(*args)
    torch.cuda.synchronize()
    g_p = nls_cuda.nls_topk_bwd_plain(*args)
    off = off_integer(geo["prop_h"]) & off_integer(geo["prop_w"])
    errs = []
    for gk, gp, what, mask in zip(g_k, g_p, ("g_vid0", "g_vid1", "g_prop_h",
                                             "g_prop_w"),
                                  (None, None, off, off)):
        if mask is not None:
            gk, gp = gk[mask], gp[mask]
        err, scale = grad_close(gk, gp, f"B2 search_bench crop {what}")
        require(scale > 0, f"B2 search_bench crop {what}: 0")
        errs.append(err)
    out["B2 err"] = max(errs)
    out["B2 ms"] = cuda_ms(lambda: nls_cuda.nls_topk_bwd(*args), n=5,
                           warm=1)
    out["B2 plain ms"] = cuda_ms(lambda: nls_cuda.nls_topk_bwd_plain(*args),
                                 n=1, warm=0)
    out["B2 bound"] = bound_ms(*b2_work(args))
    log(f"[search_bench] B2 on the crop: max|kernel-plain| {out['B2 err']:.3e}"
        f" (g_vid0, g_vid1, positions at {int(off.sum())} of {off.numel()} "
        "(q, k) off integers)")
    return out


def refine_crop_phase(torch, v6, fl7):
    """The refine (the twin's: wr 3, K 10, ps 7, 3 heads) on an
    SB_REFINE_CROP^2 crop, its given offsets the crop search's moved by
    SB_FRACTION: the selection in SB_REFINE_BANDS bands against the whole
    plain lattice (dists and offsets at TOL), and the gradients into the
    video and the offsets through B2 against the plain lattice's autograd
    at 1e-4 * max|ref|. Returns the largest errors."""
    from stnls_tpu_torch.search import NonLocalSearch, RefineSearch
    from stnls_tpu_torch.search import refinement
    from stnls_tpu_torch.search.utils import unshape_vid
    n = SB_REFINE_CROP
    v = unshape_vid(v6[..., :n, :n]).contiguous()
    fl = fl7[:, 0, ..., :n, :n].contiguous()
    HD = v6.shape[1]
    with torch.no_grad():
        _, inds = NonLocalSearch(21, 3, 7, 10, nheads=HD, stride0=1,
                                 self_action="anchor")(v, v, fl)
    given = inds.float()
    given[..., 1:] += SB_FRACTION
    refine = RefineSearch(21, 3, wr=3, k=10, ps=7, nheads=HD, stride0=1)
    rng = np.random.default_rng(SEED + 17)
    out = {}
    for route in ("kernels", "plain"):
        vv, gg = v.clone().requires_grad_(), given.clone().requires_grad_()
        reset_counts()
        if route == "kernels":
            cells = HD * v6.shape[2] * n * n * 10 * 9
            saved = refinement.SELECT_CELLS
            refinement.SELECT_CELLS = -(-cells // SB_REFINE_BANDS)
            try:
                d, i = refine(vv, vv, gg)
            finally:
                refinement.SELECT_CELLS = saved
        else:
            from stnls_tpu_torch.search.utils import shape_vids
            v6c = shape_vids(HD, [vv])[0]
            d, i = refinement._lattice_route(v6c, v6c, gg, refine.cfg)
        if route == "kernels":
            g_d = torch.from_numpy(rng.standard_normal(tuple(d.shape))
                                   .astype(np.float32)).to(d.device)
            g_i = torch.from_numpy(rng.standard_normal(tuple(i.shape))
                                   .astype(np.float32)).to(d.device)
        loss = (torch.where(d.isfinite(), d, 0.) * g_d).sum() \
            + (i * g_i).sum()
        grads = torch.autograd.grad(loss, (vv, gg))
        torch.cuda.synchronize()
        out[route] = (d.detach(), i.detach(), grads, read_counts())
    d_k, i_k, g_k, (lk, pk) = out["kernels"]
    d_p, i_p, g_p, (lp, pp) = out["plain"]
    require(lk["nls_topk_bwd"] == 1 and not any(pk.values()),
            f"refine crop: the kernel route's backward was not B2: {lk}")
    require(lp["nls_topk_bwd"] == 0, "refine crop: B2 on the plain lattice")
    err_d = close(d_k, d_p, "refine crop dists (bands vs whole lattice)")
    err_i = close(i_k, i_p, "refine crop offsets (bands vs whole lattice)")
    errs = []
    for gk, gp, what in zip(g_k, g_p, ("g_vid", "g_offsets")):
        err, scale = grad_close(gk, gp, f"refine crop {what}")
        require(scale > 0, f"refine crop {what}: 0")
        errs.append(err)
    log(f"[search_bench] refine on the {n}^2 crop: selection in "
        f"{SB_REFINE_BANDS} bands vs the whole plain lattice: dists "
        f"{err_d:.3e}, offsets {err_i:.3e}; B2's gradients vs the lattice's "
        f"autograd: video {errs[0]:.3e}, offsets {errs[1]:.3e}")
    return dict(err_fwd=max(err_d, err_i), err_bwd=max(errs))


def card_vs_cpu(torch, dev, label, fn, inputs):
    """fn on CUDA copies of the numpy inputs against fn on CPU tensors:
    outputs at TOL, the gradients of a seeded loss into the float inputs
    at 1e-4 * max|ref|. Returns the largest errors."""
    rng = np.random.default_rng(SEED + 18)
    res = {}
    for where in ("cpu", dev):
        ins = [torch.from_numpy(x).to(where).requires_grad_(
            x.dtype == np.float32) for x in inputs]
        outs = fn(*ins)
        if where == "cpu":
            cot = [torch.from_numpy(rng.standard_normal(tuple(o.shape))
                                    .astype(np.float32)) for o in outs]
        loss = sum((torch.where(o.isfinite(), o.float(), 0.)
                    * c.to(where)).sum() for o, c in zip(outs, cot)
                   if o.is_floating_point())
        grads = torch.autograd.grad(loss, [x for x in ins
                                           if x.requires_grad],
                                    allow_unused=True,
                                    materialize_grads=True)
        res[where] = ([o.detach().cpu() for o in outs],
                      [g.cpu() for g in grads])
    err_f = max(close(a.float(), b.float(), f"{label} output")
                for a, b in zip(res[dev][0], res["cpu"][0]))
    err_g = max([0.] + [grad_close(a, b, f"{label} gradient")[0]
                        for a, b in zip(res[dev][1], res["cpu"][1])])
    return err_f, err_g


def flavours_phase(torch, dev):
    """PairedSearch (the lazy route through B1/B2 and the paired anchor
    through B5/B6), PairedRefine, RandIndsSearch (noise from a seeded
    torch.Generator on the CPU, passed to both), N3MatMultSearch and
    NonLocalSearch's lattice route (pt 2, reflect_bounds=False) at
    SB_SMALL^2 on the card against the same call on the CPU."""
    from stnls_tpu_torch import search as S
    rng = np.random.default_rng(SEED + 19)
    B, HD, T, F, n = 1, 2, 3, 4, SB_SMALL

    def arr(*shape, scale=1., shift=0.):
        return (scale * rng.standard_normal(shape) + shift).astype(
            np.float32)

    frames = (arr(B, HD * F, n, n), arr(B, HD * F, n, n))
    flow = arr(B, HD, 2, n, n, scale=2., shift=SB_FRACTION)
    vids = (arr(B, T, HD * F, n, n), arr(B, T, HD * F, n, n))
    fk2 = arr(B, HD, n, n, 4, 2, scale=2., shift=SB_FRACTION)
    flows = arr(B, T, 2, 2, n, n, scale=1.5, shift=SB_FRACTION)
    noise = torch.Generator().manual_seed(SEED)
    rands = [torch.randn(vids[0].shape, generator=noise).numpy()
             for _ in range(2)]
    rand_inds = S.rand_inds.init({"ws": 3, "wt": 1, "ps": 3, "k": 4,
                                  "stride0": 1, "nheads": HD})
    cases = {
        "PairedSearch lazy": (S.PairedSearch(5, ps=3, k=4, nheads=HD,
                                             stride0=1),
                              frames + (flow,)),
        "PairedSearch anchor": (S.PairedSearch(5, ps=3, k=4, nheads=HD,
                                               stride0=1,
                                               self_action="anchor"),
                                frames + (flow,)),
        "PairedRefine": (S.PairedRefine(7, 3, 5, ps=3, nheads=HD, stride0=1,
                                        self_action="anchor"),
                         frames + (fk2,)),
        "RandIndsSearch": (lambda v0, v1, r0, r1: rand_inds(
            v0, v1, rands=(r0, r1)), vids + tuple(rands)),
        "N3MatMultSearch": (S.N3MatMultSearch(3, 1, ps=3, k=6, nheads=HD),
                            vids),
        "NonLocalSearch pt 2": (S.NonLocalSearch(3, 1, 3, 4, nheads=HD,
                                                 pt=2, self_action="anchor"),
                                vids + (flows,)),
        "NonLocalSearch reflect_bounds=False": (
            S.NonLocalSearch(3, 1, 3, 4, nheads=HD, reflect_bounds=False,
                             self_action="anchor"), vids + (flows,)),
    }
    errs = {}
    for label, (fn, inputs) in cases.items():
        reset_counts()
        errs[label] = card_vs_cpu(torch, dev, label, fn, inputs)
        launches = {k: c for k, c in read_counts()[0].items() if c}
        log(f"[flavours] {label} at {n}^2: card vs CPU outputs "
            f"{errs[label][0]:.3e}, gradients {errs[label][1]:.3e}; "
            f"launches {launches}")
    return errs


def stack_refine_phase(torch, dev, data):
    """NonLocalAttentionStack's two-stage path at the slice's widths: the
    search with use_state_update, then search_name="refine" (wr 3) with
    ref_itype="int" on its state; the second stage's forward and backward
    into the video and the parameters through the kernels (B1 and B3 in
    the first stage; B3, B4 and B2 in the second) against plain_route()."""
    from stnls_tpu_torch.attn_step import attention_module
    from stnls_tpu_torch.nn import NonLocalAttentionStack
    from stnls_tpu_torch.utils.config import ConfigDict
    vid, fflow, bflow = data[:3]
    flows = ConfigDict(fflow=fflow, bflow=bflow)
    s1 = attention_module(SEED + 1, dev, search={"use_state_update": True},
                          cls=NonLocalAttentionStack)
    s2 = attention_module(SEED + 2, dev, search={
        "search_name": "refine", "wr": 3, "use_state_update": True},
        attn={"ref_itype": "int"}, cls=NonLocalAttentionStack)
    require(s2.search.itype == "int", "the refine stage is not int")
    res = {}
    for route in ("kernels", "plain"):
        ctx = plain_route() if route == "plain" else contextlib.nullcontext()
        reset_counts()
        with ctx:
            with torch.no_grad():
                _, state = s1(vid, flows, state=[torch.zeros(()), None])
            v = vid.clone().requires_grad_()
            out, state2 = s2(v, flows, state=state)
            names, params = zip(*s2.named_parameters())
            grads = torch.autograd.grad(out.pow(2).mean(), (v,) + params)
        torch.cuda.synchronize()
        res[route] = (out.detach(), grads, state2, read_counts())
    out, grads, state2, (launches, plain) = res["kernels"]
    require(tuple(out.shape) == tuple(vid.shape) and
            bool(out.isfinite().all()) and state2[0].ndim == 7,
            "stack refine: output or state")
    require(launches["nls_topk_fwd"] == 1 and
            launches["nls_topk_bwd"] == 1 and
            launches["agg_gather_fwd"] == 2 and
            launches["agg_gather_bwd"] == 1 and not any(plain.values()),
            f"stack refine: launches {launches}, plain calls {plain}")
    err = close(out, res["plain"][0], "stack refine output kernels vs plain")
    errs = [grad_close(g, r, f"stack refine {name}")[0]
            for g, r, name in zip(grads, res["plain"][1],
                                  ("vid",) + names)]
    log(f"[stack refine] two stages at the slice (second: refine wr 3, "
        f"int): launches {launches}; output {err:.3e}, gradients "
        f"{max(errs):.3e} off the plain route")
    return dict(launches=launches, err=max(err, max(errs)))


def search_bench_phase(torch, dev, smi_line, data):
    """Phase 16. Returns the JSON fields and B1's and B2's "search_bench"
    entries for the kernels line."""
    from stnls_tpu_torch.ops import nls_cuda
    from stnls_tpu_torch.attn_step import cuda_ms
    t0 = time.perf_counter()
    res, launches = search_bench_run(torch, dev, smi_line)
    v6, fl7, b1_kw, b2_args = search_bench_kernel_args(torch, res)
    with torch.no_grad():
        d_k, c_k = nls_cuda.nls_topk(v6, v6, fl7, itype="float", **b1_kw)
        t_b1 = cuda_ms(lambda: nls_cuda.nls_topk(v6, v6, fl7, itype="float",
                                                 **b1_kw), n=2, warm=0)
        t_b1i = cuda_ms(lambda: nls_cuda.nls_topk(v6, v6, fl7, itype="int",
                                                  **b1_kw), n=2, warm=0)
    b1_bound = bound_ms(*b1_work(v6, v6, fl7, d_k, c_k, ws=b1_kw["ws"],
                                 wt=b1_kw["wt"], ps=b1_kw["ps"]))
    del d_k, c_k
    t_b2 = cuda_ms(lambda: nls_cuda.nls_topk_bwd(*b2_args), n=3, warm=1)
    b2_bound = bound_ms(*b2_work(b2_args))
    b2_at = b2_atomics(torch, b2_args)
    log(f"[times] {smi_line}: search_bench B1 {t_b1:.3f} ms float, "
        f"{t_b1i:.3f} int (bound {b1_bound[0]:.3f} by {b1_bound[1]}); B2 at "
        f"the refine's winners {t_b2:.3f} ms (bound {b2_bound[0]:.3f} by "
        f"{b2_bound[1]}; {b2_at['global_atomics']} global atomics, the "
        f"first version's {b2_at['first_version']})")
    del b2_args
    torch.cuda.empty_cache()
    crop = search_bench_crop(torch, v6, fl7, b1_kw)
    refine = refine_crop_phase(torch, v6, fl7)
    del v6, fl7, res["data"]
    torch.cuda.empty_cache()
    flavours = flavours_phase(torch, dev)
    stack = stack_refine_phase(torch, dev, data)
    secs = time.perf_counter() - t0
    log(f"[search_bench] phase 16 took {secs:.1f} s")
    lines = {name: dict(ms=r["ms"], peak_gb=r["peak_gb"])
             for name, r in res.items()}
    entry = {
        "B1": dict(ms=t_b1, int_ms=t_b1i, launches=launches["nls_topk_fwd"],
                   bound_ms=b1_bound[0], bound_by=b1_bound[1],
                   library_ms=None, crop=dict(
                       size=SB_CROP, ms=crop["B1 float ms"],
                       int_ms=crop["B1 int ms"],
                       plain_ms_a_head=crop["B1 float plain ms (a head)"],
                       int_plain_ms_a_head=crop["B1 int plain ms (a head)"],
                       bound_ms=crop["B1 bound"][0], max_abs_err=0.)),
        "B2": dict(ms=t_b2, launches=launches["nls_topk_bwd"],
                   bound_ms=b2_bound[0], bound_by=b2_bound[1],
                   library_ms=None, atomics=b2_at, crop=dict(
                       size=SB_CROP, ms=crop["B2 ms"],
                       plain_ms=crop["B2 plain ms"],
                       bound_ms=crop["B2 bound"][0],
                       max_abs_err=crop["B2 err"]))}
    return dict(lines=lines, entry=entry, refine=refine, flavours=flavours,
                stack=stack, seconds=secs, errs={"B2": crop["B2 err"]})


# Phase 17: the scatter path (graph_opts and NonLocalScatter on an int
# search) at the slice's widths: B 1, T 5, 2 heads of F 8, 128^2, ws 5,
# wt 2, ps 3, K 10 and, as the slot labels need an integer key grid,
# stride1 1; smooth flows rounded to integers. The video's scale keeps
# the dists near 1, so that softmax(-10 d) spreads its weight over the
# slots and B2 gets a cotangent that is not 0 (at scale 1 the dists of a
# normal video are ~144 and every weight but the anchor's underflows)
SCATTER = dict(B=1, T=5, HD=2, F=8, H=128, W=128, ws=5, wt=2, ps=3, k=10)
SCATTER_SCALE = 0.03


def scatter_inputs(torch, dev):
    """The seeded video [B,T,HD*F,H,W] and the rounded search flows
    [B,T,W_t-1,2,H,W] of smooth fflow and bflow."""
    from stnls_tpu_torch.attn_step import smooth_flows
    from stnls_tpu_torch.nn.flow import search_flow
    c = SCATTER
    rng = np.random.default_rng(SEED + 20)
    B, T, H, W = c["B"], c["T"], c["H"], c["W"]
    vid = torch.from_numpy((SCATTER_SCALE * rng.standard_normal(
        (B, T, c["HD"] * c["F"], H, W))).astype(np.float32))
    fflow, bflow = (torch.from_numpy(smooth_flows(rng, (B, T, 2, H, W)))
                    for _ in range(2))
    flows = search_flow(fflow, bflow, c["wt"], 1).round()
    return vid.to(dev), flows.contiguous().to(dev)


def scatter_search():
    from stnls_tpu_torch.search import NonLocalSearch
    c = SCATTER
    return NonLocalSearch(ws=c["ws"], wt=c["wt"], ps=c["ps"], k=c["k"],
                          nheads=c["HD"], stride0=1, stride1=1,
                          self_action="anchor", itype="int")


def scatter_step(torch, search, vid, flows):
    """The int search, w = softmax(-10 d), the slot labels, NonLocalScatter
    (S = labels.max()+1), the weights scattered to and gathered from the
    slots, their top-K, and the loss mean(stack.sum(2)^2)."""
    from stnls_tpu_torch.graph_opts import scatter_labels, scatter_tensor, \
        gather_tensor
    from stnls_tpu_torch.agg import NonLocalScatter
    c = SCATTER
    B, HD, T, H, W, K = c["B"], c["HD"], c["T"], c["H"], c["W"], c["k"]
    d, inds = search(vid, vid, flows)
    w = torch.softmax(-10. * d, -1)
    names, labels = scatter_labels.run(flows, inds, c["ws"], c["wt"], 1, 1,
                                       H, W, True)
    stack, mask = NonLocalScatter(ps=c["ps"], stride0=1)(vid, w, inds,
                                                         labels)
    args = (inds, labels, 1, 1, H, W)
    s_w = scatter_tensor.run(w, *args)
    s_i = scatter_tensor.run(inds, *args, invalid=0)
    s_l = scatter_tensor.run(labels.reshape(B, HD, T, H, W, K), *args,
                             invalid=-1)
    g_w = gather_tensor.run(w, *args)
    top = scatter_tensor.run_topk(s_w, s_i, s_l, K)
    loss = stack.sum(2).pow(2).mean()
    return dict(d=d, inds=inds, w=w, names=names, labels=labels,
                stack=stack, mask=mask, s_w=s_w, g_w=g_w, top=top,
                loss=loss)


def scatter_phase(torch, dev, smi_line):
    """Phase 17. The scatter step forward and backward into the video
    through the kernels (B1 once, B2 once, no plain backward; the
    scatter's backward is autograd's), then through plain_route(): offsets,
    labels, names, mask and the top-K's labels equal, B1's dists at TOL,
    the stack, the scattered and gathered weights and the top-K weights at
    1e-4 * max|ref|, the video gradient at 1e-4 * max|ref| and non-zero. Its
    times, peak memory, S against slot_bound, and B1's and B2's times and
    bounds at its arguments. Returns the JSON fields and B1's and B2's
    "scatter_path" entries for the kernels line."""
    from stnls_tpu_torch.attn_step import cuda_ms
    from stnls_tpu_torch.graph_opts import scatter_labels
    from stnls_tpu_torch.ops import nls_cuda
    from stnls_tpu_torch.search.non_local_search import search_route
    from stnls_tpu_torch.search.utils import shape_vids
    c = SCATTER
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    vid, flows = scatter_inputs(torch, dev)
    search = scatter_search()
    route = search_route(search.cfg, tuple(shape_vids(c["HD"], [vid])[0]
                                           .shape))
    require(route == "topk", f"scatter path: the search's route is {route}")
    res = {}
    for name in ("kernels", "plain"):
        ctx = plain_route() if name == "plain" else contextlib.nullcontext()
        v = vid.clone().requires_grad_()
        reset_counts()
        with ctx:
            out = scatter_step(torch, search, v, flows)
            g, = torch.autograd.grad(out["loss"], v)
        torch.cuda.synchronize()
        out = {k: tuple(x.detach() for x in o) if isinstance(o, tuple)
               else o.detach() for k, o in out.items()}
        res[name] = (out, g, read_counts())
    out, g, (launches, plain) = res["kernels"]
    ref, g_ref, (p_launches, _) = res["plain"]
    require(launches["nls_topk_fwd"] == 1 and launches["nls_topk_bwd"] == 1
            and launches["nls_geometry_fwd"] == 1
            and sum(launches.values()) == 3 and not any(plain.values()),
            f"scatter path: launches {launches}, plain calls {plain}")
    require(not any(p_launches.values()),
            f"scatter path: the plain route launched {p_launches}")
    for key in ("inds", "labels", "names", "mask"):
        require(torch.equal(out[key], ref[key]),
                f"scatter path: {key} differ from the plain route's")
    require(torch.equal(out["top"][2], ref["top"][2]) and
            torch.equal(out["top"][1], ref["top"][1]),
            "scatter path: run_topk's labels or offsets differ")
    errs = {"dists": close(out["d"], ref["d"], "scatter path dists")}
    for key, a, b in (("stack", out["stack"], ref["stack"]),
                      ("scattered weights", out["s_w"], ref["s_w"]),
                      ("gathered weights", out["g_w"], ref["g_w"]),
                      ("top-K weights", out["top"][0], ref["top"][0]),
                      ("g_vid", g, g_ref)):
        fin = b.isfinite()
        require(torch.equal(fin, a.isfinite()),
                f"scatter path {key}: the empty slots differ")
        errs[key], scale = grad_close(a[fin], b[fin], f"scatter path {key}")
        require(scale > 0, f"scatter path {key}: 0")
    S = int(out["labels"].max()) + 1
    bound = scatter_labels.slot_bound(c["ws"], c["wt"], 1, c["T"], True)
    require(S <= bound and tuple(out["stack"].shape) == (
        c["B"], c["HD"], S, c["T"], c["F"], c["H"], c["W"]),
        f"scatter path: S {S} (slot_bound {bound}) or stack shape "
        f"{tuple(out['stack'].shape)}")
    log(f"[scatter] route {route}; launches {launches}; S = {S} slots "
        f"(slot_bound {bound}); stack {tuple(out['stack'].shape)}; offsets, "
        "labels, names, mask and top-K labels equal to the plain route's; "
        + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
        + " (max|kernels-plain|)")
    del res, out, ref, g, g_ref

    def fwd():
        with torch.no_grad():
            scatter_step(torch, search, vid, flows)

    def fwd_bwd():
        v = vid.clone().requires_grad_()
        torch.autograd.grad(scatter_step(torch, search, v, flows)["loss"],
                            v)

    ms_f = cuda_ms(fwd, n=5, warm=1)
    torch.cuda.reset_peak_memory_stats(dev)
    ms_fb = cuda_ms(fwd_bwd, n=5, warm=1)
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    calls = {}
    with captured_kernel_args(calls):
        fwd_bwd()
    (a1, kw1, (d1, c1)), = calls["B1"]
    a2, = calls["B2"]
    live = float((a2[6] != 0).float().mean())
    require(live > 0.5, f"scatter path: B2's cotangent is 0 at {1 - live:.2%}"
            " of the (query, slot) pairs")
    with torch.no_grad():
        t_b1 = cuda_ms(lambda: nls_cuda.nls_topk(*a1, **kw1), n=5)
        t_b1p = cuda_ms(lambda: nls_cuda.nls_topk_plain(*a1, **kw1), n=3,
                        warm=1)
    t_b2 = cuda_ms(lambda: nls_cuda.nls_topk_bwd(*a2), n=5)
    t_b2p = cuda_ms(lambda: nls_cuda.nls_topk_bwd_plain(*a2), n=3, warm=1)
    b1b = bound_ms(*b1_work(*a1, d1, c1, ws=kw1["ws"], wt=kw1["wt"],
                            ps=kw1["ps"]))
    b2b = bound_ms(*b2_work(a2))
    secs = time.perf_counter() - t0
    log(f"[times] {smi_line}: scatter path forward {ms_f:.3f} ms, fwd+bwd "
        f"{ms_fb:.3f} ms (peak {peak:.3f} GB; S {S}); B1 {t_b1:.3f} ms "
        f"(plain {t_b1p:.3f}, bound {b1b[0]:.4f} by {b1b[1]}); B2 "
        f"{t_b2:.3f} ms (plain {t_b2p:.3f}, bound {b2b[0]:.4f} by "
        f"{b2b[1]}; its cotangent non-zero at {live:.2%} of the (query, "
        f"slot) pairs); phase 17 took {secs:.1f} s")
    entry = {"B1": dict(ms=t_b1, plain_ms=t_b1p, launches=1,
                        max_abs_err=errs["dists"],
                        bound_ms=b1b[0], bound_by=b1b[1], library_ms=None),
             "B2": dict(ms=t_b2, plain_ms=t_b2p, launches=1,
                        max_abs_err=errs["g_vid"], bound_ms=b2b[0],
                        bound_by=b2b[1], library_ms=None)}
    return dict(fields=dict(forward_ms=ms_f, fwd_bwd_ms=ms_fb, peak_gb=peak,
                            slots=S, slot_bound=bound, route=route,
                            b2_live_share=live, max_abs_err=errs,
                            phase_seconds=secs),
                entry=entry)


def agg_bench_phase(torch, dev, smi_line):
    """Phase 18. The twin of benchmarks/agg_bench.py at its published size
    (512^2, ps 7) through the kernels: each aggregator's time a call and
    peak memory from the port's RecordIt, the launches of B3 (three
    aggregators), B7 and B9 (one warm-up and 5 calls each) and no other;
    each output against its plain version on the same inputs at TOL (the
    gathers' plain stack slot by slot, which keeps its patch table within
    memory, and GatherAdd against the sum of those slots); B3's, B7's and
    B9's times, plain times and bounds at these arguments. Returns the
    JSON fields and the kernels' "agg_bench" entries."""
    from stnls_tpu_torch import agg_bench
    from stnls_tpu_torch.attn_step import cuda_ms
    from stnls_tpu_torch.ops import agg_cuda, agg_sp_cuda as sp
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    reset_counts()
    res = agg_bench.run(device=dev, log=lambda line: log(
        f"[agg_bench] {smi_line}: {line}"))
    torch.cuda.synchronize()
    launches, plain = read_counts()
    calls = 6
    want = {"gather": "B3", "gather_int": "B3", "gather_add": "B3",
            "scatter_add": "B7", "pool": "B9"}
    for name, key in want.items():
        got = res[name]["launches"]
        require(got[key] == calls and sum(got.values()) == calls,
                f"agg_bench {name}: launches {got}")
    require(launches["agg_gather_fwd"] == 3 * calls and
            launches["agg_scatter_add_fwd"] == calls and
            launches["agg_pool_fwd"] == calls and
            sum(launches.values()) == 5 * calls and not any(plain.values()),
            f"agg_bench: launches {launches}, plain calls {plain}")
    d = res["data"]
    vid, w, fl, outs, cfg = d["vid"], d["weights"], d["flows"], d["outs"], \
        d["cfg"]
    ps, K = cfg["ps"], cfg["K"]
    errs, plain_ms = {}, {}
    with torch.no_grad():
        for name, itype in (("gather", "float"), ("gather_int", "int")):
            total, err, ms = 0., 0., 0.
            for k in range(K):
                wk = w[..., k:k + 1].contiguous()
                fk = fl[..., k:k + 1, :].contiguous()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                ref = agg_cuda.nl_gather_stack_plain(vid, wk, fk, ps=ps,
                                                     stride0=1, itype=itype)
                end.record()
                end.synchronize()
                ms += start.elapsed_time(end)
                err = max(err, close(outs[name][:, :, k], ref[:, :, 0],
                                     f"agg_bench {name} slot {k}"))
                if name == "gather":
                    total = total + ref[:, :, 0]
                del ref
            errs[name], plain_ms[name] = err, ms
            if name == "gather":
                errs["gather_add"] = close(outs["gather_add"], total,
                                           "agg_bench gather_add")
                del total
        with plain_route():
            for name in ("scatter_add", "pool"):
                ref = d["menu"][name](vid, w, fl)
                errs[name] = close(outs[name], ref, f"agg_bench {name}")
                del ref
    for name, out in outs.items():
        require(bool(out.isfinite().all()) and float(out.abs().max()) > 0,
                f"agg_bench {name}: non-finite or 0")
    log(f"[agg_bench] outputs vs their plain versions: " + ", ".join(
        f"{k} {e:.3e}" for k, e in errs.items()))
    scfg = dict(ps=ps, strideIn=1, strideOut=1)
    pcfg = dict(ps=ps, stride0=1)
    with torch.no_grad():
        t = {"B3": cuda_ms(lambda: agg_cuda.nl_gather_stack(
                 vid, w, fl, ps=ps, stride0=1), n=5),
             "B7": cuda_ms(lambda: sp.nl_scatter_add(vid, w, fl, **scfg),
                           n=5),
             "B9": cuda_ms(lambda: sp.nl_pool(vid, w, fl, **pcfg), n=5)}
        plain_ms["B7"] = cuda_ms(lambda: sp.nl_scatter_add_plain(
            vid, w, fl, **scfg), n=3, warm=1)
        plain_ms["B9"] = cuda_ms(lambda: sp.nl_pool_plain(vid, w, fl,
                                                          **pcfg), n=3,
                                 warm=1)
        terms = {"B7": agg_terms(torch, sp.nl_scatter_add_plain, vid,
                                 w != 0, fl, scfg),
                 "B9": agg_terms(torch, sp.nl_pool_plain, vid, w >= 1e-8,
                                 fl, pcfg)}
        bounds = {"B3": bound_ms(*b3_work(vid, w, fl, ps)),
                  "B7": sp_forward_bound("B7", terms["B7"], vid, w, fl,
                                         outs["scatter_add"]),
                  "B9": sp_forward_bound("B9", terms["B9"], vid, w, fl,
                                         outs["pool"])}
    plain_ms["B3"] = plain_ms["gather"]
    secs = time.perf_counter() - t0
    log(f"[times] {smi_line}: agg_bench at {cfg['H']}^2, ps {ps}: " + "; "
        .join(f"{key} {t[key]:.3f} ms (plain {plain_ms[key]:.3f}"
              + (" in K slot calls" if key == "B3" else "")
              + f", bound {bounds[key][0]:.4f} by {bounds[key][1]})"
              for key in t) + f"; phase 18 took {secs:.1f} s")
    err_of = {"B3": max(errs[n] for n in ("gather", "gather_int",
                                          "gather_add")),
              "B7": errs["scatter_add"], "B9": errs["pool"]}
    name_of = {"B3": "agg_gather_fwd", "B7": "agg_scatter_add_fwd",
               "B9": "agg_pool_fwd"}
    entry = {key: dict(ms=t[key], plain_ms=plain_ms[key],
                       launches=launches[name_of[key]],
                       max_abs_err=err_of[key], bound_ms=bounds[key][0],
                       bound_by=bounds[key][1], library_ms=None)
             for key in t}
    lines = {name: {k: r[k] for k in ("ms", "mem_gb", "peak_gb")}
             for name, r in res.items() if name != "data"}
    return dict(fields=dict(lines=lines, max_abs_err=errs,
                            phase_seconds=secs), entry=entry)


T_START = time.perf_counter()


GEO_NAMES = ("prop_h", "prop_w", "tj_k", "valid", "inds")


def geometry_case(torch, smi_line, label, step, inputs):
    """G1 and G2 at the arguments that one call of step(*inputs) gives G1:
    G1's outputs bitwise equal to nls_geometry_plain's on the card (its
    stride1 a power of two, where torch's division by it is exact too),
    G2's flow gradient from seeded cotangents at TOL * max|ref| against
    nls_geometry_bwd_plain (autograd through the plain version); the
    CUDA-event times of both and of their plain versions, and their bounds
    from the bytes each reads and writes."""
    import math
    from stnls_tpu_torch.attn_step import cuda_ms
    from stnls_tpu_torch.ops import nls_geometry_cuda as geo
    calls = {}
    with captured_kernel_args(calls):
        step(*inputs)
    (flows, cells, kw), = calls["G1"]
    del calls
    require(math.frexp(kw["stride1"])[0] == 0.5,
            f"G1 {label}: stride1 {kw['stride1']} is not a power of two")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reset_counts()
    with torch.no_grad():
        out = geo.nls_geometry(flows, cells, **kw)
        ref = geo.nls_geometry_plain(flows, cells, **kw)
    require(read_counts()[0]["nls_geometry_fwd"] == 1,
            f"G1 {label}: not one launch")
    for a, b, name in zip(out, ref, GEO_NAMES):
        b = b.to(a.dtype)                   # tj_k: int64 -> int32
        same = torch.equal(a.view(torch.int32), b.view(torch.int32)) \
            if a.dtype == torch.float32 else torch.equal(a, b)
        require(same, f"G1 {label}: {name} differs from the plain version")
    g1_bytes = nb(flows, cells, *out)
    g1_bound = bound_ms(g1_bytes, cells.numel() * FLOPS_PER_CELL["G1"])
    del out, ref
    torch.cuda.empty_cache()
    with torch.no_grad():
        t_g1 = cuda_ms(lambda: geo.nls_geometry(flows, cells, **kw), n=5)
        t_g1p = cuda_ms(lambda: geo.nls_geometry_plain(flows, cells, **kw),
                        n=3, warm=1)

    full = dict(dict(query_t0=None, T_global=None, halo=0, full_ws=True,
                     itype="float", anchor=False), **kw)
    gen = torch.Generator(flows.device).manual_seed(SEED + 19)
    g_ph, g_pw = (torch.randn(cells.shape, device=flows.device,
                              generator=gen) for _ in range(2))
    g_inds = torch.randn(tuple(cells.shape) + (3,), device=flows.device,
                         generator=gen)
    g_args = (flows, cells, g_ph, g_pw, g_inds)
    reset_counts()
    g_k = geo.nls_geometry_bwd(*g_args, **full)
    torch.cuda.synchronize()
    g_p = geo.nls_geometry_bwd_plain(*g_args, **full)
    err, scale = grad_close(g_k, g_p, f"G2 {label} g_flows")
    require(scale > 0, f"G2 {label}: the flows' gradient is 0")
    require(torch.equal(g_k, geo.nls_geometry_bwd(*g_args, **full)),
            f"G2 {label}: two calls differ")
    g2_bytes = nb(*g_args, g_k)
    g2_bound = bound_ms(g2_bytes, cells.numel() * FLOPS_PER_CELL["G2"])
    del g_k, g_p
    torch.cuda.empty_cache()
    t_g2 = cuda_ms(lambda: geo.nls_geometry_bwd(*g_args, **full), n=5)
    t_g2p = cuda_ms(lambda: geo.nls_geometry_bwd_plain(*g_args, **full),
                    n=2, warm=1)
    log(f"[geometry] {label}: cells {tuple(cells.shape)}, flows "
        f"{tuple(flows.shape)}, stride1 {kw['stride1']}: G1's "
        f"{', '.join(GEO_NAMES)} bitwise equal to the plain version's; G2 "
        f"max|g| {scale:.3e}, max|kernel-plain| {err:.3e}, two calls equal")
    log(f"[times] {smi_line}: {label} G1 {t_g1:.3f} ms (plain {t_g1p:.3f}; "
        f"bound {g1_bound[0]:.4f} by {g1_bound[1]}, {g1_bytes / 1e9:.2f} "
        f"GB); G2 {t_g2:.3f} ms (plain {t_g2p:.3f}; bound "
        f"{g2_bound[0]:.4f} by {g2_bound[1]}, {g2_bytes / 1e9:.2f} GB)")
    del g_args, g_ph, g_pw, g_inds, flows, cells
    torch.cuda.empty_cache()
    return {"G1": dict(ms=t_g1, plain_ms=t_g1p, bound_ms=g1_bound[0],
                       bound_by=g1_bound[1], max_abs_err=0.),
            "G2": dict(ms=t_g2, plain_ms=t_g2p, bound_ms=g2_bound[0],
                       bound_by=g2_bound[1], max_abs_err=err)}


def geometry_phase(torch, dev, smi_line, matrix):
    """Phase 19: geometry_case at config 7's and config 6's arguments."""
    from stnls_tpu_torch import matrix_steps as ms
    torch.cuda.empty_cache()
    step, inputs, _, _ = matrix["align1080p_fwd+bwd"]
    rows = {"config7": geometry_case(torch, smi_line, "config 7 1080p",
                                     step, inputs)}
    inputs = ms.make_inputs(DENOISER, SEED, device=dev)
    rows["config6"] = geometry_case(
        torch, smi_line, "config 6 540p",
        ms.make_step(DENOISER, seed=SEED + 6), inputs)
    return rows


# RVRT's alignment at rvrt256's widths (bench_h100/configs/rvrt256.json):
# a batch of 2 clips of 64^2 features (256^2 frames at 1/4 scale), 192
# channels projected to 12 heads of 32, ws 9, K 9, prod distances; smooth
# flows of amplitude 2
RVRT_ALIGN = dict(B=2, h=64, w=64, C=192, heads=12, ws=9, k=9, flow_amp=2.)


def rvrt_align_phase(torch, dev, smi_line):
    """Phase 20: one RVRT alignment (models/rvrt.Align, its four (query
    frame, key frame) pairs in one PairedSearch and one NonLocalGather
    call) at RVRT_ALIGN, forward and the backward of a seeded cotangent
    into its inputs and parameters. Through the kernels: one launch each
    of B1, G1, B3, B4 and B2, counted from zero, and no plain backward.
    Against the plain lazy route (plain_route) on the same inputs: B1's
    dists and offsets (G1's geometry) bitwise equal, the aligned features
    at TOL, every gradient at TOL times the larger of its max|ref| and
    the median gradient's (k's bias has none but rounding). At the
    alignment gave them: B2, B3 and B4 against their plain versions at
    TOL * max|ref| (position and offset gradients off the integer
    lattice). Returns {kernel: dict(ms, bound_ms, bound_by, launches,
    max_abs_err)} with the CUDA-event time of each at those arguments."""
    from stnls_tpu_torch.attn_step import cuda_ms, smooth_flows
    from stnls_tpu_torch.models.rvrt import Align
    from stnls_tpu_torch.ops import nls_cuda, agg_cuda, \
        nls_geometry_cuda as geo
    c = RVRT_ALIGN
    B, h, w, C = c["B"], c["h"], c["w"], c["C"]
    rng = np.random.default_rng(SEED + 20)
    torch.manual_seed(SEED + 20)
    align = Align(C, c["heads"], c["ws"], c["k"]).to(dev)
    feats = [torch.from_numpy(rng.standard_normal((B, 2, h, w, C))
                              .astype(np.float32)).to(dev) for _ in range(3)]
    flows = torch.from_numpy(smooth_flows(rng, (B, 4, 2, h, w),
                                          amp=c["flow_amp"])).to(dev) \
        .reshape(B, 2, 2, 2, h, w)
    g_out = torch.from_numpy(rng.standard_normal((B, 2, h, w, C))
                             .astype(np.float32)).to(dev)
    names = ["f_q", "f_k", "p"] + [n for n, _ in align.named_parameters()]

    def run():
        x = [f.clone().requires_grad_() for f in feats]
        sel = []
        o, _ = align(*x, flows, sel)
        grads = torch.autograd.grad(o, x + list(align.parameters()), g_out)
        return o.detach(), sel[0], grads

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reset_counts()
    calls = {}
    with captured_kernel_args(calls):
        o_k, sel_k, g_k = run()
    torch.cuda.synchronize()
    launches, plain_calls = read_counts()
    one_each = ("nls_topk_fwd", "nls_geometry_fwd", "agg_gather_fwd",
                "agg_gather_bwd", "nls_topk_bwd")
    require(all(launches[k] == 1 for k in one_each) and
            not any(v for k, v in launches.items() if k not in one_each),
            f"rvrt256 Align: launches {launches}, not one each of B1, G1, "
            "B3, B4 and B2")
    require(not any(plain_calls.values()),
            "rvrt256 Align: a plain backward ran on the kernel route")
    require({k: len(v) for k, v in calls.items()} ==
            {k: 1 for k in ("B1", "G1", "B3", "B4", "B2")},
            f"rvrt256 Align: kernel calls {calls.keys()}")
    with plain_route():
        o_p, sel_p, g_p = run()
    for key in ("dists", "inds"):
        require(torch.equal(sel_k[key], sel_p[key]), f"rvrt256 Align: the "
                f"search's {key} differ from the plain lazy route's")
    err_o = close(o_k, o_p, "rvrt256 Align output vs the plain route")
    # each gradient at TOL times the larger of its own max|ref| and the
    # median tensor's: k's bias has no gradient in exact arithmetic (it
    # adds q . b to all 2K logits of a query), only rounding
    scales = [float(b.abs().max()) for b in g_p]
    median = sorted(scales)[len(scales) // 2]
    err_g = 0.
    for a, b, n, scale in zip(g_k, g_p, names, scales):
        err = float((a - b).abs().max())
        require(bool(a.isfinite().all()) and err <= TOL * max(scale, median),
                f"rvrt256 Align grad {n} vs the plain route: max|err| "
                f"{err:.3e} > 1e-4 * {max(scale, median):.3e}")
        err_g = max(err_g, err / max(scale, median))
    del o_p, g_p, sel_p, g_k

    (a1, kw1, (d1, c1)), = calls["B1"]
    (g1_flows, g1_cells, g1_kw), = calls["G1"]
    a2, = calls["B2"]
    a3, = calls["B3"]
    a4, = calls["B4"]
    errs = {"B1": 0., "G1": 0.}
    g_b2 = nls_cuda.nls_topk_bwd(*a2)
    torch.cuda.synchronize()
    g_b2p = nls_cuda.nls_topk_bwd_plain(*a2)
    off = off_integer(a2[2]) & off_integer(a2[3])
    errs["B2"] = max(grad_close(
        gk if mask is None else gk[mask], gp if mask is None else gp[mask],
        f"B2 rvrt256 {what}")[0] for gk, gp, what, mask in zip(
            g_b2, g_b2p, ("g_vid0", "g_vid1", "g_prop_h", "g_prop_w"),
            (None, None, off, off)))
    del g_b2, g_b2p
    with torch.no_grad():
        s_k = agg_cuda.nl_gather_stack(*a3[:3], **a3[3])
        torch.cuda.synchronize()
        s_p = agg_cuda.nl_gather_stack_plain(*a3[:3], **a3[3])
    errs["B3"] = close(s_k, s_p, "B3 rvrt256 stack vs plain")
    del s_k, s_p
    g_b4 = agg_cuda.nl_gather_stack_bwd(*a4)
    torch.cuda.synchronize()
    g_b4p = agg_cuda._gather_bwd_plain(*a4)
    off = off_integer(a4[2][..., 1]) & off_integer(a4[2][..., 2])
    errs["B4"] = 0.
    for gk, gp, what in zip(g_b4, g_b4p, ("g_vid", "g_weights", "g_flows")):
        if gk is None:
            require(gp is None, f"B4 rvrt256: {what} only on one side")
            continue
        if what == "g_flows":
            gk, gp = gk[..., 1:][off], gp[..., 1:][off]
        errs["B4"] = max(errs["B4"], grad_close(gk, gp,
                                                f"B4 rvrt256 {what}")[0])
    del g_b4, g_b4p
    torch.cuda.empty_cache()

    g1_out = geo.nls_geometry(g1_flows, g1_cells, **g1_kw)
    bounds = {"B1": bound_ms(*b1_work(*a1, d1, c1, ws=kw1["ws"],
                                      wt=kw1["wt"], ps=kw1["ps"])),
              "G1": bound_ms(nb(g1_flows, g1_cells, *g1_out),
                             g1_cells.numel() * FLOPS_PER_CELL["G1"]),
              "B3": bound_ms(*b3_work(*a3[:3], a3[3]["ps"],
                                      a3[3]["stride0"])),
              "B2": bound_ms(*b2_work(a2)),
              "B4": bound_ms(*b4_work(a4))}
    del g1_out
    with torch.no_grad():
        t = {"B1": cuda_ms(lambda: nls_cuda.nls_topk(*a1, **kw1), n=5),
             "G1": cuda_ms(lambda: geo.nls_geometry(g1_flows, g1_cells,
                                                    **g1_kw), n=5),
             "B3": cuda_ms(lambda: agg_cuda.nl_gather_stack(
                 *a3[:3], **a3[3]), n=5),
             "B2": cuda_ms(lambda: nls_cuda.nls_topk_bwd(*a2), n=5),
             "B4": cuda_ms(lambda: agg_cuda.nl_gather_stack_bwd(*a4), n=5)}
    kernel = dict(B1="nls_topk_fwd", G1="nls_geometry_fwd",
                  B3="agg_gather_fwd", B2="nls_topk_bwd",
                  B4="agg_gather_bwd")
    log(f"[rvrt256] Align at {B} clips of {h}x{w}, {c['heads']} heads of "
        f"{2 * C // c['heads']}, ws {c['ws']}, K {c['k']}, prod (video "
        f"{tuple(a1[0].shape)}): launches {launches}; B1's dists and "
        f"offsets bitwise equal to the plain lazy route's; output "
        f"max|kernels-plain| {err_o:.3e}, gradients {err_g:.3e} of the "
        "larger of max|ref| and the median tensor's; "
        "max|kernel-plain| at its arguments " + ", ".join(
            f"{k} {v:.3e}" for k, v in errs.items()))
    log(f"[times] {smi_line}: rvrt256 Align: " + "; ".join(
        f"{k} {t[k]:.3f} ms (bound {bounds[k][0]:.4f} by {bounds[k][1]})"
        for k in t))
    return {kernel[k]: dict(ms=t[k], bound_ms=bounds[k][0],
                            bound_by=bounds[k][1],
                            launches=launches[kernel[k]],
                            max_abs_err=errs[k]) for k in t}


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
    atom = res["b4_atomics"]
    require(atom["first_version"] >= 10 * atom["global_atomics"],
            f"B4: {atom['global_atomics']} global atomics at the slice, not "
            f"10x below the first version's {atom['first_version']}")
    graft = kernel_phase(torch, dev, "graft 64^2", dict(H=64, wt=1, k=8,
                                                        stride1=1))
    vres = volume_kernel_phase(torch, dev, "slice 128^2",
                               dict(H=128, wt=2, stride1=0.5))
    vgraft = volume_kernel_phase(torch, dev, "graft 64^2",
                                 dict(H=64, wt=1, stride1=1))
    at = vres["b6_atomics"]["dense"]
    require(at["first_design"] >= 8 * at["global_atomics"],
            f"B6: {at['global_atomics']} global atomics on the slice's dense "
            f"cotangent, not 8x below the first design's "
            f"{at['first_design']}")

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
        ("nls_topk_fwd", "nls_topk_bwd", "nls_geometry_fwd",
         "nls_geometry_bwd", "agg_gather_fwd", "agg_gather_bwd"),
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
    log(f"[times] {smi_line}: B5 {t_b5:.3f} ms (previous design "
        f"{EARLIER_MS['B5 slice']}; plain {t_b5p:.3f}, bound "
        f"{vres['bounds']['B5'][0]:.3f}); " + "; ".join(
            f"B6 {kind} {t_b6[kind]:.3f} ms (previous design "
            f"{EARLIER_MS[f'B6 slice {kind}']}; plain {t_b6p[kind]:.3f}, "
            f"bound {vres['bounds'][f'B6 {kind}'][0]:.3f})" for kind in t_b6))
    log(f"[times] {smi_line}: volume NonLocalAttention forward {t_vol:.3f} "
        f"ms = {T / (t_vol / 1e3):.1f} frames/s (plain {t_volp:.3f} ms); "
        f"fwd+bwd {t_vol_train:.3f} ms = {T / (t_vol_train / 1e3):.2f} "
        f"frames/s (plain {t_vol_trainp:.3f} ms)")
    log(f"[times] {smi_line}: B1 {t_b1:.3f} ms (plain {t_b1p:.3f}); "
        f"B2 {t_b2:.3f} ms (previous design {EARLIER_MS['B2 slice']}; plain "
        f"{t_b2p:.3f}; bound {res['bounds']['B2'][0]:.4f}); B3 {t_b3:.3f} ms "
        f"(previous design {EARLIER_MS['B3 slice']}; plain {t_b3p:.3f}; "
        f"bound {res['bounds']['B3'][0]:.4f}); B4 {t_b4:.3f} ms (plain "
        f"{t_b4p:.3f})")
    log(f"[times] {smi_line}: forward step {t_step:.3f} ms = "
        f"{T / (t_step / 1e3):.1f} frames/s (plain {t_stepp:.3f} ms); "
        f"fwd+bwd step {t_train:.3f} ms = {T / (t_train / 1e3):.2f} "
        f"frames/s (plain {t_trainp:.3f} ms)")

    # 8. the aggregation kernels against their plain versions
    from stnls_tpu_torch import agg_example
    from stnls_tpu_torch.ops import agg_sp_cuda as sp
    a_cfg = agg_example.CONFIG
    ares = {label: agg_kernel_phase(torch, dev, label, *case)
            for label, case in agg_cases(torch, dev).items()}

    # 9. the agg example's twin at full width
    agg_twin = agg_example_phase(torch, dev)

    # 10. times of B7-B10 and of the twin; B7-B10 also at 512^2, on the
    # dense case and on the strided 64^2
    def agg_times(label, plain_too):
        args = ares[label]["args"]
        t = {}
        with torch.no_grad():
            for key, fwd, plain in (("B7", sp.nl_scatter_add,
                                     sp.nl_scatter_add_plain),
                                    ("B9", sp.nl_pool, sp.nl_pool_plain)):
                x, cfg = args[key]
                t[key] = (cuda_ms(lambda: fwd(*x, **cfg)),) + ((cuda_ms(
                    lambda: plain(*x, **cfg), n=5, warm=1),)
                    if plain_too else ())
            for key, bwd, plain in (("B8", sp.nl_scatter_add_bwd,
                                     sp._scatter_add_bwd_plain),
                                    ("B10", sp.nl_pool_bwd,
                                     sp._pool_bwd_plain)):
                t[key] = (cuda_ms(lambda: bwd(*args[key])),) + ((cuda_ms(
                    lambda: plain(*args[key]), n=5, warm=1),)
                    if plain_too else ())
        return t

    t_agg = agg_times("agg example 128^2", True)
    v6_t, w_t, o_t = agg_twin["search"]
    t_aggs = cuda_ms(lambda: agg_example.aggregate(v6_t, w_t, o_t, **a_cfg))
    with plain_route():
        t_aggsp = cuda_ms(lambda: agg_example.aggregate(v6_t, w_t, o_t,
                                                        **a_cfg), n=3, warm=1)
    t_twin = cuda_ms(lambda: agg_example.run(*agg_twin["inputs"], a_cfg))
    t_more = {label: {key: t[0] for key, t in agg_times(label, False).items()}
              for label in ("agg example 512^2", "agg example dense 128^2",
                            "strided 64^2")}
    twin_bounds = ares["agg example 128^2"]["bounds"]
    log(f"[times] {smi_line}: " + "; ".join(
        f"{key} {t_agg[key][0]:.3f} ms ("
        + (f"previous design {EARLIER_MS[f'{key} agg example']}; "
           if f"{key} agg example" in EARLIER_MS else "")
        + f"plain {t_agg[key][1]:.3f}, bound "
        f"{twin_bounds[key][0]:.4f} by {twin_bounds[key][1]})"
        for key in ("B7", "B8", "B9", "B10")))
    for label, t in t_more.items():
        log(f"[times] {smi_line}: {label} " + "; ".join(
            f"{key} {t[key]:.3f} ms (bound "
            f"{ares[label]['bounds'][key][0]:.4f} by "
            f"{ares[label]['bounds'][key][1]})"
            for key in ("B7", "B8", "B9", "B10")))
    # B3 runs twice a step of the twin (Gather, GatherAdd), on its search
    b3_agg = bound_ms(*b3_work(v6_t, w_t, o_t, a_cfg["ps"]))
    log(f"[times] {smi_line}: agg example, the four aggregators fwd+bwd "
        f"{t_aggs:.3f} ms (plain route {t_aggsp:.3f} ms); search + the four "
        f"{t_twin:.3f} ms; B3's bound there {b3_agg[0]:.4f} ms by "
        f"{b3_agg[1]}")

    # 11. B1, B5 and B6 at other (ps, F a head), and K beyond B1's list
    err_ps = ps_kernel_phase(torch, dev)

    # 12. benchmarks/matrix.py's configs 1, 4, 5 and 7 at full size, and
    # config 7's B1 and B2 against their plain versions on its whole frames
    matrix = matrix_phase(torch, dev)
    err_full, b2_full_bound, b2_full = full_frame_phase(
        torch, "align1080p_fwd+bwd", matrix["align1080p_fwd+bwd"][1])
    b2_c4 = b2_config4_phase(torch, smi_line, matrix)

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

    # 15. the model layer: config 6's denoiser train step at 540p and on
    # a crop against the plain route; the stack attention and StackConv;
    # vnlb and flow_patches
    torch.cuda.empty_cache()
    den = denoiser_phase(torch, dev, smi_line)
    stacks = stack_phase(torch, dev, smi_line, data, step)
    vn = vnlb_phase(torch, dev, smi_line)

    # 16. the search layer: benchmarks/search_bench.py's twin at full size,
    # B1/B2 at its arguments, the refine against the plain lattice, the
    # other flavours against the CPU, the stack's refine stage
    torch.cuda.empty_cache()
    sbp = search_bench_phase(torch, dev, smi_line, data)

    # 17. the scatter path: an int search (B1, backward B2), slot labels,
    # NonLocalScatter and graph_opts at the slice's widths
    scat = scatter_phase(torch, dev, smi_line)

    # 18. benchmarks/agg_bench.py's twin at 512^2, ps 7 (B3, B7, B9)
    abp = agg_bench_phase(torch, dev, smi_line)

    # 19. the geometry kernels G1 and G2 at config 7's and config 6's
    # arguments
    geo_rows = geometry_phase(torch, dev, smi_line, matrix)

    # 20. RVRT's alignment at rvrt256's widths: B1, G1, B3, B4 and B2 one
    # launch each, against the plain lazy route and their plain versions
    rvrt = rvrt_align_phase(torch, dev, smi_line)

    require("jax" not in sys.modules, "JAX was imported")
    log(f"[chip_smoke] phases 1-20 took {time.perf_counter() - T_START:.1f} "
        "s")
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
                  B6=vres["bounds"]["B6 each"], **twin_bounds)
    errs = {key: max(r["err"][key], g["err"][key])
            for r, g in ((res, graft), (vres, vgraft)) for key in r["err"]}
    for key in twin_bounds:
        errs[key] = max(a["err"][key] for a in ares.values())
    errs["B6"] = max(errs["B6"], err_ps)
    errs["B2"] = max(errs["B2"], err_full, b2_c4["err"], sbp["errs"]["B2"])
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
        if key == "B6":
            # B6's global atomic instructions a backward at the slice
            entry["stats"] = vres["b6_atomics"]
        if key in den["rows"]:
            # at config 6's arguments (540x960, 2 heads of 8, K 8), its
            # launches a train step
            entry["config6"] = dict(den["rows"][key],
                                    launches=den["launches"][name])
        if key in sbp["entry"]:
            # at search_bench's arguments (512^2, 3 heads of F 9, ws 21,
            # W_t 3, ps 7, K 10; B2 at its refine's winners), launches in
            # its sequence, and on a crop against the plain versions
            entry["search_bench"] = sbp["entry"][key]
        if key in scat["entry"]:
            # phase 17: at the scatter step's arguments (int search, 128^2,
            # 2 heads of F 8, ws 5, W_t 5, ps 3, K 10), launches a step
            entry["scatter_path"] = scat["entry"][key]
        if key in abp["entry"]:
            # phase 18: at agg_bench's arguments (512^2, 2 heads of F 8,
            # T 3, K 10, ps 7), launches in its sequence
            entry["agg_bench"] = abp["entry"][key]
        if name in rvrt:
            # phase 20: at rvrt256's alignment (2 clips of 64^2, 12 heads
            # of 32, ws 9, K 9, prod), launches an alignment
            entry["rvrt256"] = rvrt[name]
        if key in t_chunk:
            entry["chunk"] = dict(t_chunk[key],
                                  launches=chunk_launches[name],
                                  max_abs_err=chunk_errs[key],
                                  library_ms=None)
        kernels.append(entry)
    # G1 and G2: the port's own kernels (the JAX package builds this
    # geometry in XLA, with no pl.pallas_call), at config 7's arguments;
    # launches from phase 5's kernel route
    for key, name in (("G1", "nls_geometry_fwd"), ("G2", "nls_geometry_bwd")):
        row = geo_rows["config7"][key]
        kernels.append(dict({
            "name": name, "route": "cuda",
            "source": "stnls_tpu_torch/csrc/nls_geometry.cu",
            "replaces": None, "launches": train_launches[name]},
            **row, library_ms=None, config6=geo_rows["config6"][key]))
        if name in rvrt:
            kernels[-1]["rvrt256"] = rvrt[name]
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
        "matrix": dict({name: {
            "ms": ms, "frames_per_s": matrix[name][1][0].shape[1] / (ms / 1e3),
            "peak_gb": matrix[name][3]} for name, ms in t_matrix.items()},
            **{DENOISER: {"ms": den["ms"],
                          "frames_per_s": 3 / (den["ms"] / 1e3),
                          "peak_gb": den["peak_gb"]}}),
        "model_layer": {
            "stack_fwd_bwd_ms": stacks["stack"]["fwd_bwd_ms"],
            "stack_conv_fwd_bwd_ms": stacks["stack_conv"]["fwd_bwd_ms"],
            "vnlb": {key: vn[key] for key in (
                "ms", "bayes_filter_ms", "psnr_in", "psnr_out", "size")}},
        "ps1_kernels": ps1, "compiled_vs_run_time_ms": spec,
        "b4_slice_atomics": res["b4_atomics"],
        "b2_slice_atomics": res["b2_atomics"],
        "b2_config7_full_frames": dict(
            ms=b2_full["ms"], bound_ms=b2_full_bound[0],
            bound_by=b2_full_bound[1], atomics=b2_full["atomics"]),
        "b2_config4": b2_c4,
        "b3_multichip_twin": twin["b3"],
        "b3_agg_example_bound_ms": b3_agg[0],
        **{f"agg_example_{tag}": {key: dict(
            ms=ms, bound_ms=ares[label]["bounds"][key][0],
            bound_by=ares[label]["bounds"][key][1])
            for key, ms in t_more[label].items()}
           for tag, label in (("512", "agg example 512^2"),
                              ("dense", "agg example dense 128^2"),
                              ("strided", "strided 64^2"))},
        "earlier_ms": EARLIER_MS,
        "time_sharded_config7": {
            "step_ms_in_turns": sharded["ms"][0::3],
            "time_sharded_ms_in_turns": sharded["ms"][1:3],
            "peak_gb": sharded["peak_gb"]},
        "multichip_twin": {"train_step_ms": twin["ms"],
                           "losses": twin["losses"]},
        "search_bench": {"lines": sbp["lines"], "refine_crop": sbp["refine"],
                         "flavours": sbp["flavours"],
                         "stack_refine": sbp["stack"],
                         "phase_seconds": sbp["seconds"]},
        "scatter_path": scat["fields"],
        "agg_bench": abp["fields"],
        "script_seconds": time.perf_counter() - T_START}}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
