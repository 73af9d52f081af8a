"""Time B5 (stnls_tpu_torch/csrc/nls_vol_fwd.cu) and B6
(stnls_tpu_torch/csrc/nls_vol_bwd.cu) against variants of them on one
NVIDIA GPU, in turns (shipped, variants, variants in reverse, shipped),
each variant's outputs held to the shipped kernel's (B5 bitwise, B6 at
1e-4 * max|ref|).

Run from the repository root:

    mkdir -p build/variants/previous_vol
    for f in nls_vol_fwd.cu nls_vol_bwd.cu nls_common.cuh; do
        git show REV:stnls_tpu_torch/csrc/$f > build/variants/previous_vol/$f
    done
    python3 -m stnls_tpu_torch.b5_b6_variants [--previous DIR]

Variants:
  previous (with --previous DIR, default build/variants/previous_vol when
    it holds the three sources): the kernels' sources of an earlier
    revision with the C interface they had before the redesign (planar
    videos; B5 one thread per (query, slot, window row) and scalar corner
    loads, B6 one thread per (query, slot) and a scalar global atomic per
    corner), each built alone beside its own nls_common.cuh and called as
    its wrapper called it then.
  rows (B5): csrc/variants/nls_vol_fwd_rows.cu, one thread per (query,
    slot, window row) in place of one per (query, slot).
  noreuse (B5): the shipped source reading every corner column from
    memory, without taking it from the registers that hold it.
  run-time body (B5): the shipped library's run-time body where (ps, F)
    has a compiled one (nls_vol_cuda.COMPILED_BODY).
  box, box vw2, box vw1 (B6): csrc/variants/nls_vol_bwd_box.cu, a private
    box of the key region in shared memory per thread, flushed once, its
    side `box_side` (box_extent capped to what fits BOX_SMEM), at the
    layout's vector width and at 2 and 1 channels a vector over the same
    channels-last layout (the script swaps cuda_lib.channel_layout);
    global vw2: the shipped kernel at 2 channels a vector.
  lb1, lb3 (B6): the shipped source with its launch bound at 1 block an
    SM, or at 3 at every vector width.
  copies given (B6): the shipped kernel handed B5's channels-last copies
    of the videos, as the volume path's backward is (_SearchVolume); the
    other runs make them. Also timed alone: the wrapper's zeroing and
    transposing back of B6's two channels-last accumulators, against
    zeroing two planar gradients as the first design's wrapper did.
Cases: the slice's (ps, F) = (3, 8) on 128^2 (chip_smoke's volume kernel
phase: its inputs and centres), B6 on a dense cotangent and on the
per-frame top-2 of anchor_each; (1, 2) on the 270x480 crop of config 5's
inputs (benchmarks/matrix.py; chip_smoke's phase 13), B6 on the per-frame
top-2 and on a dense cotangent; (1, 16) on the crop of config 4's (W_t =
1: every centre is its query's pixel), B6 on the per-frame top-2, and the
same with the centres scattered (each moved by a seeded integer offset in
[-16, 16] per axis, clamped into the frame; the same cotangent), so that
neighbouring queries no longer read neighbouring pixels. Prints the
card's name and power limit, the ptxas report of each kernel built, the
CUDA-event medians in turns and B6's global atomics a backward (the
kernels' counts for the shipped and the box variant; the previous
design's, 4 corners x ps^2 x F per active cell plus ps^2 x F per active
(query, slot), from the shapes). Exits non-zero without a CUDA device.
Imports nothing of JAX.
"""

import argparse
import ctypes
import json
import math
import sys
from pathlib import Path

import numpy as np

from stnls_tpu_torch import variant_tools as vt

# B5's and B6's variants: (source under csrc/, text substitutions)
B5_VARIANTS = {
    "rows": ("variants/nls_vol_fwd_rows.cu", []),
    "noreuse": ("nls_vol_fwd.cu", [("constexpr bool kReuseColumns = true;",
                                    "constexpr bool kReuseColumns = false;")])}
_BOUND = "__launch_bounds__(256, VW == 4 ? 2 : 3)"
B6_VARIANTS = {
    "lb1": ("nls_vol_bwd.cu", [(_BOUND, "__launch_bounds__(256, 1)")]),
    "lb3": ("nls_vol_bwd.cu", [(_BOUND, "__launch_bounds__(256, 3)")])}
BOX_SOURCE = "variants/nls_vol_bwd_box.cu"
BOX_THREADS = 128           # threads a block of the box variant (kBoxThreads)
BOX_SMEM = 112 * 1024       # bytes of boxes a block: two blocks an SM
# B6's runs at other vector widths: name: (library, channels a vector or
# None for the layout's own)
B6_WIDTHS = {"box": ("box", None), "box vw2": ("box", 2),
             "box vw1": ("box", 1), "global vw2": ("shipped", 2)}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the C interfaces of the kernels before the redesign
PREVIOUS = {"nls_vol_fwd": ("stnls_nls_vol_fwd",
                            [_P] * 5 + [_I] * 18 + [_F, _F] + [_I] * 5 + [_P]),
            "nls_vol_bwd": ("stnls_nls_vol_bwd",
                            [_P] * 9 + [_I] * 18 + [_F, _F] + [_I] * 4 + [_P])}


def box_extent(ws, ps, stride1, dilation, itype):
    """The pixels a side of the box variant's box: every unreflected
    bilinear corner of a slot's ws x ws cells lies within floor((ws-1) *
    stride1) + dilation * (ps-1) + 2 rows (and columns) of the box's
    origin, the slot's first lattice position plus the first tap's
    offset; one more absorbs the rounding of the lattice positions."""
    s1 = float(max(1, int(stride1))) if itype == "int" else float(stride1)
    return math.floor((ws - 1) * s1) + int(dilation) * (ps - 1) + 3


def box_side(cfg, vw):
    """The box variant's side at vw channels a vector: box_extent, capped
    so that its boxes, side^2 * vw floats * BOX_THREADS, fit BOX_SMEM."""
    E = box_extent(cfg["ws"], cfg["ps"], cfg["stride1"], cfg["dilation"],
                   cfg["itype"])
    return min(E, math.isqrt(BOX_SMEM // (BOX_THREADS * vw * 4)))


def cases(torch, cs, dev):
    """{label: (B5's arguments, its keywords, {cotangent kind: g_d})}."""
    from stnls_tpu_torch import matrix_steps as ms
    from stnls_tpu_torch.ops import nls_vol_cuda
    from stnls_tpu_torch.ops.nls import search_centres
    from stnls_tpu_torch.ops.nls_k import search_aux, aux_to_inds3
    out = {}
    rng = np.random.default_rng(cs.SEED + 3)
    v0, v1, fl = cs.make_inputs(torch, rng, dev, B=1, HD=2, T=5, F=8,
                                H=128, W=128, wt=2)
    kw = dict(ws=5, wt=2, ps=3, stride0=1, stride1=0.5, dist_type="l2",
              itype="float")
    groups = {"slice (3, 8) 128^2": (v0, v1, fl, kw, ("dense", "each"))}
    cfg = ms.config("align1080p_fwd")
    v, f = cs.matrix_search_args(torch, cfg, cs.crop_inputs(
        ms.make_inputs("align1080p_fwd", cs.SEED, device=dev),
        *cs.MATRIX_CROP))
    groups["config 5 (1, 2) 270x480 crop"] = (
        v, v, f, dict(ws=cfg["ws"], wt=cfg["wt"], ps=1, stride0=1,
                      stride1=1, dist_type="l2", itype=cfg["itype"]),
        ("each", "dense"))
    cfg = ms.config("gda540p_ws9")
    v, f = cs.matrix_search_args(torch, cfg, cs.crop_inputs(
        ms.make_inputs("gda540p_ws9", cs.SEED, device=dev), *cs.MATRIX_CROP))
    c4 = "config 4 (1, 16) 270x480 crop"
    groups[c4] = (v, v, f, dict(ws=cfg["ws"], wt=cfg["wt"], ps=1, stride0=1,
                                stride1=1, dist_type="l2",
                                itype=cfg["itype"]), ("each",))
    for label, (a, b, flows, kw, kinds) in groups.items():
        ctr = tuple(x.contiguous() for x in search_centres(
            a.shape, flows, wt=kw["wt"], stride0=1, itype=kw["itype"]))
        with torch.no_grad():
            d = nls_vol_cuda.nls_volume(a, b, *ctr, **kw)
        aux = search_aux(a.shape, flows, ws=kw["ws"], wt=kw["wt"],
                         stride0=1, stride1=kw["stride1"],
                         itype=kw["itype"])
        g = {kind: cs.volume_cotangent(torch, rng, d, aux_to_inds3(
            aux, d.shape), kind, kw["wt"]).contiguous() for kind in kinds}
        out[label] = ((a, b) + ctr, kw, g)
    # config 4's centres scattered: the same reads, not neighbouring
    a, kw, g = out[c4]
    H, W = a[0].shape[-2:]
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 4)
    ctr = tuple((c + torch.randint(-16, 17, c.shape, generator=gen,
                                   device=dev)).clamp(0, L - 1).contiguous()
                for c, L in zip(a[2:], (H, W)))
    out[c4 + ", scattered centres"] = (a[:2] + ctr, kw, g)
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--previous", default="build/variants/previous_vol")
    parser.add_argument("--only", choices=("B5", "B6"),
                        help="time one kernel's variants only")
    args = parser.parse_args()
    root = Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        sys.exit("b5_b6_variants: no CUDA device; it times a GPU only")
    import chip_smoke as cs
    from stnls_tpu_torch.attn_step import cuda_ms
    from stnls_tpu_torch.ops import cuda_lib, nls_vol_cuda
    card = vt.card()
    print(card, flush=True)
    shipped = cuda_lib.load()
    print(f"shipped:\n{vt.ptxas_lines(shipped.log, 'nls_vol')}", flush=True)
    out_dir = cuda_lib.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    dev = torch.device("cuda", 0)

    b5_libs, b6_libs = {"shipped": shipped}, {"shipped": shipped}
    for libs, key, variants in ((b5_libs, "nls_vol_fwd", B5_VARIANTS),
                                (b6_libs, "nls_vol_bwd", B6_VARIANTS)):
        for name, (src, subs) in variants.items():
            path, log = vt.build(cuda_lib, cuda_lib.CSRC / src, out_dir,
                                 f"{key}_{name}", subs)
            print(f"{name}:\n{vt.ptxas_lines(log)}", flush=True)
            libs[name] = vt.Variant(shipped, path, f"stnls_{key}")
    # the box variant takes the box's side before the stream
    box = {"side": 0}
    path, log = vt.build(cuda_lib, cuda_lib.CSRC / BOX_SOURCE, out_dir,
                         "nls_vol_bwd_box")
    print(f"box:\n{vt.ptxas_lines(log)}", flush=True)
    sig = cuda_lib.SIGNATURES["stnls_nls_vol_bwd"]
    b6_libs["box"] = vt.Variant(shipped, path, "stnls_nls_vol_bwd",
                                sig[:-1] + [_I, _P],
                                lambda a: a[:-1] + (box["side"], a[-1]))
    prev = {}
    prev_dir = Path(args.previous).resolve()
    if all((prev_dir / f"{k}.cu").exists() for k in PREVIOUS) and \
            (prev_dir / "nls_common.cuh").exists():
        for key, (sym, argtypes) in PREVIOUS.items():
            path, log = vt.build(cuda_lib, prev_dir / f"{key}.cu", out_dir,
                                 f"previous_{key}", include=prev_dir)
            print(f"previous {key}:\n{vt.ptxas_lines(log)}", flush=True)
            fn = getattr(ctypes.CDLL(str(path)), sym)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            prev[key] = fn
    else:
        print(f"no previous sources in {prev_dir}: timing the other variants "
              "only", flush=True)

    layout = cuda_lib.channel_layout

    def narrower(vw):
        """The channel layout with B6's lanes at vectors of vw channels
        over the same Fp channels-last channels."""
        def lanes(F):
            Fp = layout(F)[3]
            nvec = Fp // vw
            ng = min(1 << (nvec - 1).bit_length(), 32)
            return vw, ng, nvec // ng, Fp
        return lanes

    def previous_args(v0, v1, ctr_h, ctr_w, cfg):
        """The earlier kernels' shared arguments (planar videos)."""
        shape, frames = nls_vol_cuda._check("previous", v0, v1, ctr_h, ctr_w,
                                            cfg)
        B, HD, T, F = shape[:4]
        return (B, HD, T, F) + nls_vol_cuda._scalars(cfg, shape, frames)

    def previous_b5(a, kw):
        cfg = dict(kw, dilation=1, full_ws=True, use_adj=False)
        B, HD, T, F, H, W, nH, nW, W_t = previous_args(*a, cfg)[:9]
        d = torch.empty((B, HD, T, W_t, kw["ws"], kw["ws"], nH, nW),
                        device=dev)
        err = prev["nls_vol_fwd"](
            *(x.data_ptr() for x in a), d.data_ptr(),
            *previous_args(*a, cfg), 1,
            torch.cuda.current_stream().cuda_stream)
        if err:
            sys.exit(f"b5_b6_variants: the previous B5 failed ({err})")
        return d

    def previous_b6(a, g_d, cfg):
        g = [torch.zeros_like(a[0]), torch.zeros_like(a[1]),
             torch.empty_like(a[2]), torch.empty_like(a[3])]
        err = prev["nls_vol_bwd"](
            *(x.data_ptr() for x in a), g_d.data_ptr(),
            *(x.data_ptr() for x in g), *previous_args(*a, cfg),
            torch.cuda.current_stream().cuda_stream)
        if err:
            sys.exit(f"b5_b6_variants: the previous B6 failed ({err})")
        return tuple(g)

    def in_turns(runs, check):
        """CUDA-event medians of each run in turns; check(name, output)
        holds each output to the shipped one's."""
        order = list(runs) + list(runs)[::-1]
        times = {name: [] for name in runs}
        for name in order:
            check(name, runs[name]())
            times[name].append(cuda_ms(runs[name]))
        return times

    def fmt(times):
        return "; ".join(f"{name} {' / '.join(f'{t:.3f}' for t in ts)} ms"
                         for name, ts in times.items())

    results = {"card": card}
    for label, (a, kw, cots) in cases(torch, cs, dev).items():
        if args.only != "B6":
            b5_runs = {name: lambda lib=lib: (
                vt.swap(cuda_lib, lib), nls_vol_cuda.nls_volume(*a, **kw))[1]
                for name, lib in b5_libs.items()}

            def run_time():
                vt.swap(cuda_lib, shipped)
                nls_vol_cuda.COMPILED_BODY = False
                try:
                    return nls_vol_cuda.nls_volume(*a, **kw)
                finally:
                    nls_vol_cuda.COMPILED_BODY = True

            if shipped.stnls_nls_vol_compiled(kw["ps"], a[0].shape[3]):
                b5_runs["run-time body"] = run_time
            if "nls_vol_fwd" in prev:
                b5_runs["previous"] = lambda: previous_b5(a, kw)
            with torch.no_grad():
                ref = b5_runs["shipped"]()

                def check5(name, d):
                    if not torch.equal(d, ref):
                        sys.exit(f"b5_b6_variants: B5 {name} differs at "
                                 f"{label}")

                times = in_turns(b5_runs, check5)
            vt.swap(cuda_lib, shipped)
            results[f"B5 {label}"] = dict(ms=times)
            print(f"[B5 {label}] {fmt(times)}", flush=True)
        if args.only == "B5":
            continue
        cfg = dict(kw, dilation=1, full_ws=True, use_adj=False)
        F = a[0].shape[3]
        copies = cuda_lib.channels_last_pair(a[0], a[1], layout(F)[3])
        # the wrapper's own work around the kernel: two channels-last
        # accumulators zeroed and transposed back, against the first
        # design's two zeroed planar gradients
        lay = (cuda_ms(lambda: [cuda_lib.channels_first(
                   torch.zeros_like(copies[0]), F) for _ in range(2)]),
               cuda_ms(lambda: [torch.zeros_like(a[0]) for _ in range(2)]))
        results[f"B6 {label} layout"] = dict(channels_last_ms=lay[0],
                                             planar_ms=lay[1])
        print(f"[B6 {label}] two gradients: channels-last accumulators "
              f"zeroed and transposed back {lay[0]:.3f} ms, planar ones "
              f"zeroed {lay[1]:.3f} ms", flush=True)
        for kind, g_d in cots.items():
            def b6(lib, vw=None, **given):
                vt.swap(cuda_lib, b6_libs[lib])
                if vw is not None:
                    cuda_lib.channel_layout = narrower(vw)
                box["side"] = box_side(cfg, cuda_lib.channel_layout(F)[0])
                try:
                    return nls_vol_cuda.nls_volume_bwd(*a, g_d, cfg, **given)
                finally:
                    vt.swap(cuda_lib, shipped)
                    cuda_lib.channel_layout = layout

            b6_runs = {name: lambda lib=name: b6(lib) for name in b6_libs
                       if name != "box"}
            b6_runs["copies given"] = lambda: b6("shipped", copies=copies)
            b6_runs.update({name: lambda w=w: b6(*w)
                            for name, w in B6_WIDTHS.items()})
            if "nls_vol_bwd" in prev:
                b6_runs["previous"] = lambda: previous_b6(a, g_d, cfg)
            ref = b6("shipped")

            def check6(name, g):
                for gk, gr, what in zip(g[:2], ref[:2], ("g_vid0", "g_vid1")):
                    err = float((gk - gr).abs().max())
                    if err > 1e-4 * float(gr.abs().max()):
                        sys.exit(f"b5_b6_variants: B6 {name} {what} differs "
                                 f"at {label} {kind}: {err:.3e}")

            times = in_turns(b6_runs, check6)
            counts = {}
            for name in ("shipped", "box"):
                stats = torch.zeros(4, dtype=torch.int64, device=dev)
                b6(name, stats=stats)
                counts[name] = stats.tolist()
            ps = kw["ps"]
            with torch.no_grad():
                d = nls_vol_cuda.nls_volume(*a, **kw)
            live = (g_d != 0) & d.isfinite()
            cells = int(live.sum())
            slots = int(live.flatten(4, 5).any(4).sum())
            first = cells * ps * ps * F * 4 + slots * ps * ps * F
            side = box_side(cfg, layout(F)[0])
            results[f"B6 {label} {kind}"] = dict(
                ms=times, box=side, active_cells=cells, active_slots=slots,
                stats=counts, first_design_atomics=first)
            shp, bx = counts["shipped"], counts["box"]
            print(f"[B6 {label} {kind}] {fmt(times)}; global atomics a "
                  "backward (into g_vid1, into g_vid0): shipped "
                  f"{shp[:2]} = {shp[0] + shp[1]}, box ({side} x {side}) "
                  f"{bx[:2]} = {bx[0] + bx[1]} ({bx[2]} box flushes), "
                  f"first design at most {first} ({cells} active cells, "
                  f"{slots} active slots)", flush=True)
    print(json.dumps(results))


if __name__ == "__main__":
    main()
