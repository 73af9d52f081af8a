"""Time B8 (stnls_tpu_torch/csrc/agg_scatter_add_bwd.cu) and B9
(stnls_tpu_torch/csrc/agg_pool_fwd.cu) against their first design and
their variants on one NVIDIA GPU, in turns (shipped, variants, variants
in reverse, shipped), each variant's outputs held to the shipped kernel's.

Run from the repository root:

    mkdir -p build/variants/previous_sp
    for f in agg_pool_fwd.cu agg_scatter_add_bwd.cu agg_common.cuh; do
        git show REV:stnls_tpu_torch/csrc/$f > build/variants/previous_sp/$f
    done
    python3 -m stnls_tpu_torch.b8_b9_variants [--previous DIR]

Variants:
  channels_last, planar (B8): the shipped kernel on a channels-last copy
    of the cotangent, or on the planar cotangent, whatever the size (the
    wrapper picks by agg_sp_cuda.SCATTER_CHANNELS_LAST_MIN).
  channels_last (B9): stnls_tpu_torch/csrc/variants/agg_pool_fwd_cl.cu,
    the shipped design reading a channels-last copy of the video, made at
    the call through the shipped wrapper (its time included).
  halves (B8): stnls_tpu_torch/csrc/variants/agg_scatter_add_bwd_halves.cu,
    the shipped kernel with g_w's channels split over two lanes.
  batch (B8): stnls_tpu_torch/csrc/variants/agg_scatter_add_bwd_batch.cu,
    the shipped kernel with g_w taken 4 slots at a time in registers.
  min5, min6, fill4, k4 (B8): text substitutions of the shipped source
    (B8_SUBS: launch bounds, unrolled loops).
  min12, k4 (B9): text substitutions of the shipped source (B9_SUBS).
  pixel (B8): stnls_tpu_torch/csrc/variants/agg_scatter_add_bwd_pixel.cu,
    one thread a pixel for g_vid (up to 8 channels) and one a query for
    g_w, its slots' sums in shared memory.
  w_split (B8): stnls_tpu_torch/csrc/variants/agg_scatter_add_bwd_wsplit.cu,
    the shipped tile kernel for g_vid and g_w in a launch of its own, 8
    lanes a (query, slot) and a fixed-order warp reduction.
  previous (with --previous DIR, default build/variants/previous_sp when
    it holds the sources): the first design's B8 and B9 (one thread per
    output element, planar), each built alone with its own agg_common.cuh
    and called with the C interface it had.
Cases (chip_smoke.agg_cases): the agg example's twin at 128^2
(agg_example.CONFIG: B=1, T=3, F=8 a head, HD=2, K=8, ps=3, its search's
softmax(-10 d) weights and offsets), the same example at 512^2 (a 50 MB
video, a 450 MB pool output), and chip_smoke's strided 64^2 case
(agg_inputs: ps 4 -> 5, pt 2, dilation 2, use_adj, stride 2, -1e8
fills), each with a seeded cotangent for B8. Times: CUDA events around
one call, wrapper and any channels-last copy included (attn_step.cuda_ms,
median of 10 after 2 warm-ups), and the device time of one call (the sum
of its kernels', torch.profiler over 10 calls). Prints the card's name
and power limit and ptxas's registers and spills. The last line is a
JSON object of the numbers. Exits non-zero without a CUDA device.
Imports nothing of JAX.
"""

import argparse
import ctypes
import json
import sys
from pathlib import Path

from stnls_tpu_torch import variant_tools as vt

_P, _I = ctypes.c_void_p, ctypes.c_int
# the first design's C interfaces: (entry, argtypes)
PREVIOUS = {"agg_pool_fwd": ("stnls_agg_pool_fwd", [_P] * 4 + [_I] * 15 + [_P]),
            "agg_scatter_add_bwd": ("stnls_agg_scatter_add_bwd",
                                    [_P] * 6 + [_I] * 20 + [_P])}
# B8's variants that are text substitutions of the shipped source: a
# launch bound of 5 or 6 blocks of 256 threads an SM (fewer registers, one
# wave of blocks at the agg twin), and the centre table's fill unrolled
B8_SUBS = {
    "min5": [("__launch_bounds__(kPixels * NL)",
              "__launch_bounds__(kPixels * NL, 5)")],
    "min6": [("__launch_bounds__(kPixels * NL)",
              "__launch_bounds__(kPixels * NL, 6)")],
    "fill4": [("    for (int i = threadIdx.x; i < npk * kn * nr * nc;",
               "#pragma unroll 4\n    for (int i = threadIdx.x; i < npk * kn * nr * nc;")],
    "k4": [("            for (int k = 0; k < kn; ++k) {",
            "#pragma unroll 4\n            for (int k = 0; k < kn; ++k) {")]}
# B9's: a launch bound of 12 blocks of 128 threads an SM (<= 40 registers)
B9_SUBS = {"min12": [("__launch_bounds__(kCols)", "__launch_bounds__(kCols, 12)")],
           "k4": [("            for (int k = 0; k < kn; ++k) {",
                   "#pragma unroll 4\n            for (int k = 0; k < kn; ++k) {")]}


def cases(torch, cs, dev):
    """{label: (vid, weights, offsets, pool keywords, scatter keywords,
    cotangent of ScatterAdd)}."""
    from stnls_tpu_torch.ops import agg_sp_cuda as sp
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 7)
    out = {}
    for label, ((vid, w, o), scfg, pcfg) in cs.agg_cases(torch, dev, (
            "agg example 128^2", "agg example 512^2",
            "strided 64^2")).items():
        outH, outW = sp.default_out_size(*vid.shape[-2:], *w.shape[3:5],
                                         scfg["strideOut"])
        out[label] = (vid, w, o, pcfg, dict(scfg, outH=outH, outW=outW),
                      torch.randn(vid.shape[:4] + (outH, outW),
                                  generator=gen, device=dev))
    return out


def previous_pool(torch, fn, vid, weights, flows, cfg):
    """The first design's B9 as its wrapper called it."""
    from stnls_tpu_torch.ops import agg_sp_cuda as sp
    out = torch.empty(sp._pool_out_shape(vid, cfg), device=vid.device)
    err = fn(vid.data_ptr(), weights.data_ptr(), flows.data_ptr(),
             out.data_ptr(), *sp._pool_ints(vid, flows, cfg),
             torch.cuda.current_stream().cuda_stream)
    if err:
        sys.exit(f"b8_b9_variants: the previous B9 failed to launch ({err})")
    return out


class PoolChannelsLast:
    """The shipped library with B9's entry taken from the channels-last
    variant: the shipped wrapper runs as it is, and the call makes the
    channels-last copy of `vid` (set before each call) that the variant
    reads."""

    def __init__(self, shipped, fn):
        self.shipped, self.fn, self.vid = shipped, fn, None

    def stnls_agg_pool_fwd(self, vid, weights, flows, out, B, HD, K, T, F,
                           *rest):
        from stnls_tpu_torch.ops import cuda_lib
        Fp = cuda_lib.grouped_channels(F)
        vid_cl = cuda_lib.channels_last(self.vid, Fp)
        return self.fn(vid_cl.data_ptr(), weights, flows, out, B, HD, K, T,
                       F, Fp, *rest[:-2], 1, *rest[-2:])

    def __getattr__(self, name):
        return getattr(self.shipped, name)


def previous_scatter_bwd(torch, fn, vid, weights, flows, g, cfg):
    """The first design's B8 as its wrapper called it: (g_vid, g_w)."""
    from stnls_tpu_torch.ops import agg_sp_cuda as sp
    g_vid, g_w = torch.empty_like(vid), torch.empty_like(weights)
    err = fn(vid.data_ptr(), weights.data_ptr(), flows.data_ptr(),
             g.data_ptr(), g_vid.data_ptr(), g_w.data_ptr(),
             *sp._scatter_ints(vid, flows, cfg), 1, 1,
             torch.cuda.current_stream().cuda_stream)
    if err:
        sys.exit(f"b8_b9_variants: the previous B8 failed to launch ({err})")
    return g_vid, g_w


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--previous", default="build/variants/previous_sp")
    args = parser.parse_args()
    root = Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        sys.exit("b8_b9_variants: no CUDA device; it times a GPU only")
    import chip_smoke as cs
    from stnls_tpu_torch.attn_step import cuda_ms
    from stnls_tpu_torch.ops import agg_sp_cuda as sp, cuda_lib
    card = vt.card()
    print(card, flush=True)
    shipped = cuda_lib.load()
    print("shipped, registers a thread:\n" + vt.res_usage(
        shipped.path, ("agg_pool_fwd_row_kernel",
                       "agg_scatter_add_bwd_tile_kernel")), flush=True)
    out_dir = cuda_lib.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    dev = torch.device("cuda", 0)

    path, log = vt.build(cuda_lib, cuda_lib.CSRC / "variants" /
                         "agg_scatter_add_bwd_wsplit.cu", out_dir,
                         "b8_w_split")
    print(f"w_split:\n{vt.ptxas_lines(log, 'w_split')}", flush=True)
    w_split = vt.Variant(shipped, path, "stnls_agg_scatter_add_bwd")
    b8_variants = {}
    for name in ("halves", "batch", "pixel"):
        path, log = vt.build(cuda_lib, cuda_lib.CSRC / "variants" /
                             f"agg_scatter_add_bwd_{name}.cu", out_dir,
                             f"b8_{name}")
        print(f"{name}:\n{vt.ptxas_lines(log)}", flush=True)
        b8_variants[name] = vt.Variant(shipped, path,
                                       "stnls_agg_scatter_add_bwd")
    for name, subs in B8_SUBS.items():
        path, log = vt.build(cuda_lib, cuda_lib.CSRC / "agg_scatter_add_bwd.cu",
                             out_dir, f"b8_{name}", subs)
        print(f"{name}:\n{vt.res_usage(path, ('tile_kernel',))}", flush=True)
        b8_variants[name] = vt.Variant(shipped, path,
                                       "stnls_agg_scatter_add_bwd")
    path, log = vt.build(cuda_lib, cuda_lib.CSRC / "variants" /
                         "agg_pool_fwd_cl.cu", out_dir, "b9_cl")
    print(f"B9 channels_last:\n{vt.ptxas_lines(log)}", flush=True)
    b9_variants = {}
    for name, subs in B9_SUBS.items():
        path_v, _ = vt.build(cuda_lib, cuda_lib.CSRC / "agg_pool_fwd.cu",
                             out_dir, f"b9_{name}", subs)
        print(f"{name}:\n{vt.res_usage(path_v, ('row_kernel',))}", flush=True)
        b9_variants[name] = vt.Variant(shipped, path_v, "stnls_agg_pool_fwd")
    fn = getattr(ctypes.CDLL(str(path)), "stnls_agg_pool_fwd")
    fn.argtypes, fn.restype = [_P] * 4 + [_I] * 18 + [_P], _I
    pool_cl = PoolChannelsLast(shipped, fn)
    prev = {}
    prev_dir = Path(args.previous).resolve()
    if all((prev_dir / f"{k}.cu").exists() for k in PREVIOUS):
        for key in ("agg_pool_fwd", "agg_scatter_add_bwd"):
            sym, argtypes = PREVIOUS[key]
            path, log = vt.build(cuda_lib, prev_dir / f"{key}.cu", out_dir,
                                 f"previous_{key}", include=prev_dir)
            print(f"previous {key}:\n{vt.ptxas_lines(log)}", flush=True)
            fn = getattr(ctypes.CDLL(str(path)), sym)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            prev[key] = fn
    else:
        print(f"no previous sources in {prev_dir}: timing the other variants "
              "only", flush=True)

    rule = sp.SCATTER_CHANNELS_LAST_MIN

    def layout(lib, forced):
        vt.swap(cuda_lib, lib)
        sp.SCATTER_CHANNELS_LAST_MIN = rule if forced is None else forced

    def scatter_run(lib, forced):
        return lambda c: (layout(lib, forced), sp.nl_scatter_add_bwd(
            *c[:3], c[5], c[4], (True, True, False))[:2])[1]

    b9_runs = {"shipped": lambda c: (layout(shipped, None),
                                     sp.nl_pool(*c[:3], **c[3]))[1],
               "channels_last": lambda c: (
                   setattr(pool_cl, "vid", c[0]), layout(pool_cl, None),
                   sp.nl_pool(*c[:3], **c[3]))[-1],
               **{name: lambda c, lib=lib: (layout(lib, None),
                                            sp.nl_pool(*c[:3], **c[3]))[1]
                  for name, lib in b9_variants.items()}}
    b8_runs = {"shipped": scatter_run(shipped, None),
               "channels_last": scatter_run(shipped, 0),
               "planar": scatter_run(shipped, sys.maxsize),
               **{name: scatter_run(lib, None)
                  for name, lib in b8_variants.items()},
               "w_split": scatter_run(w_split, None)}
    if prev:
        b9_runs["previous"] = lambda c: previous_pool(
            torch, prev["agg_pool_fwd"], *c[:4])
        b8_runs["previous"] = lambda c: previous_scatter_bwd(
            torch, prev["agg_scatter_add_bwd"], *c[:3], c[5], c[4])

    results = {"card": card, "SCATTER_CHANNELS_LAST_MIN": rule}
    all_cases = cases(torch, cs, dev)
    with torch.no_grad():
        for label, c in all_cases.items():
            for key, runs in (("B9", b9_runs), ("B8", b8_runs)):
                ref = runs["shipped"](c)
                ref = ref if isinstance(ref, tuple) else (ref,)
                bitwise = {}
                for name, run in runs.items():
                    got = run(c)
                    got = got if isinstance(got, tuple) else (got,)
                    bitwise[name] = all(torch.equal(a, b)
                                        for a, b in zip(got, ref))
                    for a, b in zip(got, ref):
                        err = float((a - b).abs().max())
                        if err > 1e-4 * max(1., float(b.abs().max())):
                            sys.exit(f"b8_b9_variants: {key} {name} differs "
                                     f"at {label}: {err:.3e}")
                order = list(runs) + list(runs)[::-1]
                times = {name: [] for name in runs}
                dev_ms = {name: [] for name in runs}
                for name in order:
                    times[name].append(cuda_ms(lambda: runs[name](c)))
                    dev_ms[name].append(vt.device_ms(torch,
                                                  lambda: runs[name](c)))
                layout(shipped, None)
                results[f"{key} {label}"] = dict(ms=times, device_ms=dev_ms,
                                                 bitwise_to_shipped=bitwise)
                if key == "B8":
                    # the shipped kernel asked for one gradient alone
                    split = {what: vt.device_ms(torch, lambda: sp.nl_scatter_add_bwd(
                        *c[:3], c[5], c[4], needs))
                        for what, needs in (("g_vid only", (True, False, False)),
                                            ("g_w only", (False, True, False)))}
                    results[f"{key} {label}"]["device_ms_one_gradient"] = split
                    print(f"[B8 {label}] shipped device ms, one gradient: "
                          f"{split}", flush=True)
                print(f"[{key} {label}] " + "; ".join(
                    f"{name} {' / '.join(f'{t:.4f}' for t in times[name])} "
                    f"ms, device {' / '.join(f'{t:.4f}' for t in dev_ms[name])}"
                    for name in runs) + f"; bitwise to shipped: {bitwise}",
                    flush=True)
    print(json.dumps(results))


if __name__ == "__main__":
    main()
