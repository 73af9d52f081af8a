"""Time B7 (stnls_tpu_torch/csrc/agg_scatter_add_fwd.cu) and B10
(stnls_tpu_torch/csrc/agg_pool_bwd.cu) against their first design and
against each other form of their adds, video reads and bodies on one
NVIDIA GPU, in turns (shipped, variants, variants in reverse, shipped),
each variant's outputs held to the shipped kernels'; and check that B8
and B9, which share csrc/agg_common.cuh with them, are unchanged.

Run from the repository root, REV the commit before the redesign:

    mkdir -p build/variants/previous_sp
    for f in agg_scatter_add_fwd.cu agg_pool_bwd.cu agg_scatter_add_bwd.cu \\
             agg_pool_fwd.cu agg_common.cuh; do
        git show REV:stnls_tpu_torch/csrc/$f > build/variants/previous_sp/$f
    done
    git show REV:stnls_tpu_torch/ops/agg_sp_cuda.py \\
        > build/variants/previous_sp/agg_sp_cuda.py
    python3 -m stnls_tpu_torch.b7_b10_variants [--previous DIR]

The shipped kernels add into channels-last accumulators, B10 reads a
channels-last copy of the video, and ps = 3 takes a compiled body.
Variants:
  planar (B7): csrc/variants/agg_scatter_add_fwd_forms.cu, VW scalar
    atomics into the planar output;
  planar, planar_adds, planar_video (B10):
    csrc/variants/agg_pool_bwd_forms.cu with planar adds and video reads,
    planar adds only, planar video reads only;
  run_time: the run-time body at ps = 3 (agg_sp_cuda.COMPILED_BODY);
  vw2: lanes of 2 channels (the shipped layout takes 4 from F = 3 on),
    twice the lanes a query;
  smem (B10): csrc/variants/agg_pool_bwd_smem.cu, the cotangent rows of a
    block's queries staged in shared memory with coalesced loads (ps = 3
    compiled in);
  min6, min8, t64, t256, k2: text substitutions of the shipped sources
    (SUBS: launch bounds, block sizes, the slot loop unrolled);
  previous (with --previous DIR, default build/variants/previous_sp when
    it holds the sources): the first design (one thread per (query,
    slot), planar scalar atomics), built alone with its own
    agg_common.cuh and called through its own wrapper (the previous
    ops/agg_sp_cuda.py).
The forms variants are called directly (their buffers, the launch and
any layout copies), without the wrapper's checks: their call times leave
those out.
Cases (chip_smoke.agg_cases): the agg example's twin at 128^2
(agg_example.CONFIG: B=1, T=3, F=8 a head, HD=2, K=8, ps=3, its search's
softmax(-10 d) weights and offsets: one live slot in eight, at the
query's own pixel), the same example at 512^2, chip_smoke's strided 64^2
case (agg_inputs: ps 4 (pool 5), pt 2, dilation 2, use_adj, stride 2,
-1e8 fills) and the twin's video and offsets with seeded uniform (0, 1]
weights ("dense": every slot live, the destinations scattered), and the
twin and its dense case at 32^2 and 64^2 (SMALL), each with a seeded
cotangent of the pool for B10. Times: CUDA events around
one call, wrapper, zeroing and any copy included (attn_step.cuda_ms,
median of 10 after 2 warm-ups), and the device time of one call (the
sum of its kernels', copies' and memsets', torch.profiler over 10
calls); B10 asked for g_w alone too. B8 and B9: the SASS of their
kernels in the shipped library against the previous sources' build
(cuobjdump, text equal), and their outputs bitwise. Prints the card's
name and power limit and ptxas's registers and spills. The last line is
a JSON object of the numbers. Exits non-zero without a CUDA device, or
where a variant's output differs or B8's or B9's SASS changed. Imports
nothing of JAX.
"""

import argparse
import ctypes
import json
import sys
from pathlib import Path

from stnls_tpu_torch import variant_tools as vt

_P, _I = ctypes.c_void_p, ctypes.c_int
# the first design's C interfaces: (entry, argtypes)
PREVIOUS = {"agg_scatter_add_fwd": ("stnls_agg_scatter_add_fwd",
                                    [_P] * 4 + [_I] * 18 + [_P]),
            "agg_pool_bwd": ("stnls_agg_pool_bwd", [_P] * 6 + [_I] * 16 + [_P])}
# the forms variants' C interfaces: the shipped ones with the layout flags
# (B7 cl; B10 cl_vid, cl_acc) before `compiled`
FORMS = {"agg_scatter_add_fwd": [_P] * 4 + [_I] * 23 + [_P],
         "agg_pool_bwd": [_P] * 6 + [_I] * 22 + [_P]}
# B10's forms variants: (video read channels-last, adds channels-last)
B10_FORMS = {"planar": (0, 0), "planar_adds": (1, 0), "planar_video": (0, 1)}
# the kernels of B8 and B9 whose machine code must not change, by source
UNCHANGED = {"agg_scatter_add_bwd": ("stnls_agg_scatter_add_bwd",
                                     "agg_scatter_add_bwd_tile_kernel"),
             "agg_pool_fwd": ("stnls_agg_pool_fwd", "agg_pool_fwd_row_kernel")}
# small frames, where a call's host work weighs most
SMALL = ("agg example 32^2", "agg example dense 32^2", "agg example 64^2",
         "agg example dense 64^2")
# text substitutions of both shipped sources, run at the shipped layouts:
# launch bounds of 6 and 8 blocks an SM (<= 80 and 64 registers), blocks
# of 64 and 256 threads, the slot loop unrolled twice
SUBS = {"min6": [("__launch_bounds__(kThreads)", "__launch_bounds__(kThreads, 6)")],
        "min8": [("__launch_bounds__(kThreads)", "__launch_bounds__(kThreads, 8)")],
        "t64": [("constexpr int kThreads = 128;", "constexpr int kThreads = 64;")],
        "t256": [("constexpr int kThreads = 128;", "constexpr int kThreads = 256;")],
        "k2": [("for (int k = 0; k < a.K; ++k) {",
                "\n#pragma unroll 2\n      for (int k = 0; k < a.K; ++k) {")]}


def cases(torch, cs, dev):
    """{label: (vid, weights, offsets, scatter keywords with the output
    size, pool keywords, cotangent of the pool)}."""
    from stnls_tpu_torch.ops import agg_sp_cuda as sp
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 9)
    out = {}
    for label, ((vid, w, o), scfg, pcfg) in cs.agg_cases(torch, dev, (
            "agg example 128^2", "strided 64^2", "agg example 512^2",
            "agg example dense 128^2", *SMALL)).items():
        outH, outW = sp.default_out_size(*vid.shape[-2:], *w.shape[3:5],
                                         scfg["strideOut"])
        out[label] = (vid, w, o, dict(scfg, outH=outH, outW=outW), pcfg,
                      torch.randn(sp._pool_out_shape(vid, pcfg),
                                  generator=gen, device=dev))
    return out


def previous_wrapper(path):
    """The previous stnls_tpu_torch/ops/agg_sp_cuda.py at `path`, loaded
    as a module of its own: the first design's wrappers, which call the
    library that cuda_lib.load() returns with the C interface they had."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("previous_agg_sp_cuda",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forms_scatter(torch, fn, vid, weights, flows, cfg):
    """B7's forms variant with planar adds: its output."""
    from stnls_tpu_torch.ops import agg_sp_cuda as sp, cuda_lib
    vw, ng, npass, _ = cuda_lib.channel_layout(vid.shape[3])
    out = torch.zeros(vid.shape[:4] + (cfg["outH"], cfg["outW"]),
                      device=vid.device)
    err = fn(vid.data_ptr(), weights.data_ptr(), flows.data_ptr(),
             out.data_ptr(), *sp._scatter_ints(vid, flows, cfg), vw, ng,
             npass, 0, int(sp.COMPILED_BODY),
             torch.cuda.current_stream().cuda_stream)
    if err:
        sys.exit(f"b7_b10_variants: the B7 forms variant failed ({err})")
    return (out,)


def forms_pool_bwd(torch, fn, vid, weights, flows, g, cfg, cl_vid, cl_acc):
    """B10's forms variant with the video read and the adds each
    channels-last or planar: (g_vid, g_w)."""
    from stnls_tpu_torch.ops import agg_sp_cuda as sp, cuda_lib
    F = vid.shape[3]
    vw, ng, npass, Fp = cuda_lib.channel_layout(F)
    v = cuda_lib.channels_last(vid, Fp) if cl_vid else vid
    acc = vid.new_zeros(vid.shape[:3] + vid.shape[4:] + (Fp,)) if cl_acc \
        else torch.zeros_like(vid)
    g_w = torch.empty_like(weights)
    err = fn(v.data_ptr(), weights.data_ptr(), flows.data_ptr(), g.data_ptr(),
             acc.data_ptr(), g_w.data_ptr(), *sp._pool_ints(vid, flows, cfg),
             1, vw, ng, npass, cl_vid, cl_acc, int(sp.COMPILED_BODY),
             torch.cuda.current_stream().cuda_stream)
    if err:
        sys.exit(f"b7_b10_variants: the B10 forms variant failed ({err})")
    return (cuda_lib.channels_first(acc, F) if cl_acc else acc), g_w


def check_unchanged(torch, cuda_lib, prev_dir, out_dir, shipped, all_cases):
    """B8 and B9: SASS of the shipped kernels against the previous
    sources' build, and their outputs bitwise on every case."""
    from stnls_tpu_torch.ops import agg_sp_cuda as sp
    res, libs = {}, {}
    mine = vt.sass(shipped.path, [k for _, k in UNCHANGED.values()])
    for key, (sym, kernel) in UNCHANGED.items():
        path, _ = vt.build(cuda_lib, prev_dir / f"{key}.cu", out_dir,
                           f"previous_{key}", include=prev_dir)
        libs[key] = vt.Variant(shipped, path, sym)
        if mine is None:
            print("[B8/B9] no cuobjdump: machine code not compared",
                  flush=True)
            continue
        theirs = vt.sass(path, (kernel,)).get(kernel, "")
        ours = mine.get(kernel, "")
        res[f"{kernel} sass equal"] = same = bool(ours) and ours == theirs
        print(f"[B8/B9] {kernel}: SASS {'equal' if same else 'DIFFERS'} "
              f"({len(ours.splitlines())} and {len(theirs.splitlines())} "
              "lines)", flush=True)
    runs = {"agg_scatter_add_bwd": lambda c: sp.nl_scatter_add_bwd(
                *c[:3], torch.randn(c[0].shape[:4] + (c[3]["outH"],
                                                      c[3]["outW"]),
                                    generator=torch.Generator(
                                        c[0].device).manual_seed(5),
                                    device=c[0].device),
                c[3], (True, True, False))[:2],
            "agg_pool_fwd": lambda c: (sp.nl_pool(*c[:3], **c[4]),)}
    with torch.no_grad():
        for label, c in all_cases.items():
            for key, run in runs.items():
                vt.swap(cuda_lib, shipped)
                ours = run(c)
                vt.swap(cuda_lib, libs[key])
                theirs = run(c)
                vt.swap(cuda_lib, shipped)
                same = all(torch.equal(a, b) for a, b in zip(ours, theirs))
                res[f"{key} {label} bitwise"] = same
                if not same:
                    sys.exit(f"b7_b10_variants: {key} differs from the "
                             f"previous build at {label}")
    print(f"[B8/B9] {res}", flush=True)
    return res


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--previous", default="build/variants/previous_sp")
    args = parser.parse_args()
    root = Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        sys.exit("b7_b10_variants: no CUDA device; it times a GPU only")
    import chip_smoke as cs
    from stnls_tpu_torch.attn_step import cuda_ms
    from stnls_tpu_torch.ops import agg_sp_cuda as sp, cuda_lib
    card = vt.card()
    print(card, flush=True)
    shipped = cuda_lib.load()
    out_dir = cuda_lib.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    for key in FORMS:
        # the shipped source alone, for ptxas's report of its kernels
        _, log = vt.build(cuda_lib, cuda_lib.CSRC / f"{key}.cu", out_dir,
                          f"{key}_shipped")
        print("shipped:\n" + vt.ptxas_table(log, f"{key}_kernel"), flush=True)
    dev = torch.device("cuda", 0)

    def lib_fn(path, sym, argtypes):
        fn = getattr(ctypes.CDLL(str(path)), sym)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        return fn

    prev = {}
    prev_dir = Path(args.previous).resolve()
    have_prev = (prev_dir / "agg_sp_cuda.py").exists() and all(
        (prev_dir / f"{k}.cu").exists() for k in (*PREVIOUS, *UNCHANGED))
    if have_prev:
        for key, (sym, argtypes) in PREVIOUS.items():
            path, log = vt.build(cuda_lib, prev_dir / f"{key}.cu", out_dir,
                                 f"previous_{key}", include=prev_dir)
            print(f"previous {key}:\n{vt.ptxas_lines(log)}", flush=True)
            prev[key] = vt.Variant(shipped, path, sym, argtypes)
        prev_sp = previous_wrapper(prev_dir / "agg_sp_cuda.py")
    else:
        print(f"no previous sources in {prev_dir}: timing the shipped "
              "kernels and their variants only", flush=True)
    forms = {}
    for key, argtypes in FORMS.items():
        path, log = vt.build(cuda_lib, cuda_lib.CSRC / "variants" /
                             f"{key}_forms.cu", out_dir, f"{key}_forms")
        print(f"{key} forms:\n" + vt.ptxas_table(log, f"{key}_kernel"),
              flush=True)
        forms[key] = lib_fn(path, f"stnls_{key}", argtypes)

    def b7(c):
        return (sp.nl_scatter_add(*c[:3], **c[3]),)

    def b10(c, needs=(True, True, False)):
        return tuple(x for x in sp.nl_pool_bwd(*c[:3], c[5], c[4], needs)[:2]
                     if x is not None)

    def swapped(lib, run):
        def go(c):
            vt.swap(cuda_lib, lib)
            try:
                return run(c)
            finally:
                vt.swap(cuda_lib, shipped)
        return go

    def run_time(run):
        def go(c):
            sp.COMPILED_BODY = False
            try:
                return run(c)
            finally:
                sp.COMPILED_BODY = True
        return go

    layout = cuda_lib.channel_layout

    def vw2(F):
        Fp = layout(F)[3]
        if F < 3:
            return layout(F)
        ng = min(1 << (Fp // 2 - 1).bit_length(), 32)
        return 2, ng, Fp // 2 // ng, Fp

    def lanes_of_2(run):
        def go(c):
            cuda_lib.channel_layout = vw2
            try:
                return run(c)
            finally:
                cuda_lib.channel_layout = layout
        return go

    b7_runs = {"shipped": b7, "planar": lambda c: forms_scatter(
                   torch, forms["agg_scatter_add_fwd"], *c[:4]),
               "run_time": run_time(b7), "vw2": lanes_of_2(b7)}
    b10_runs = {"shipped": b10,
                **{name: lambda c, f=f: forms_pool_bwd(
                    torch, forms["agg_pool_bwd"], *c[:3], c[5], c[4], *f)
                   for name, f in B10_FORMS.items()},
                "run_time": run_time(b10), "vw2": lanes_of_2(b10)}
    path, log = vt.build(cuda_lib, cuda_lib.CSRC / "variants" /
                         "agg_pool_bwd_smem.cu", out_dir, "agg_pool_bwd_smem")
    print("smem:\n" + vt.ptxas_table(log, "agg_pool_bwd_kernel"), flush=True)
    b10_runs["smem"] = swapped(vt.Variant(shipped, path, "stnls_agg_pool_bwd"),
                               b10)
    for name, subs in SUBS.items():
        for key, runs, run in (("agg_scatter_add_fwd", b7_runs, b7),
                               ("agg_pool_bwd", b10_runs, b10)):
            path, log = vt.build(cuda_lib, cuda_lib.CSRC / f"{key}.cu", out_dir,
                                 f"{key}_{name}", subs)
            print(f"{name}:\n" + vt.ptxas_table(log, f"{key}_kernel"),
                  flush=True)
            runs[name] = swapped(vt.Variant(shipped, path, f"stnls_{key}"), run)
    if prev:
        b7_runs["previous"] = swapped(prev["agg_scatter_add_fwd"], lambda c: (
            prev_sp.nl_scatter_add(*c[:3], **c[3]),))
        b10_runs["previous"] = swapped(prev["agg_pool_bwd"], lambda c: tuple(
            prev_sp.nl_pool_bwd(*c[:3], c[5], c[4], (True, True, False))[:2]))

    results = {"card": card}
    all_cases = cases(torch, cs, dev)
    if have_prev:
        results["B8/B9 unchanged"] = check_unchanged(
            torch, cuda_lib, prev_dir, out_dir, shipped, all_cases)
    with torch.no_grad():
        for label, c in all_cases.items():
            for key, runs in (("B7", b7_runs), ("B10", b10_runs)):
                ref = runs["shipped"](c)
                bitwise = {}
                for name, run in runs.items():
                    got = run(c)
                    bitwise[name] = all(torch.equal(a, b)
                                        for a, b in zip(got, ref))
                    for a, b in zip(got, ref):
                        err = float((a - b).abs().max())
                        if err > 1e-4 * max(1., float(b.abs().max())):
                            sys.exit(f"b7_b10_variants: {key} {name} "
                                     f"differs at {label}: {err:.3e}")
                order = list(runs) + list(runs)[::-1]
                times = {name: [] for name in runs}
                dev_ms = {name: [] for name in runs}
                for name in order:
                    times[name].append(cuda_ms(lambda: runs[name](c)))
                    dev_ms[name].append(vt.device_ms(torch,
                                                     lambda: runs[name](c)))
                results[f"{key} {label}"] = dict(ms=times, device_ms=dev_ms,
                                                 bitwise_to_shipped=bitwise)
                if key == "B10":
                    alone = vt.device_ms(torch, lambda: b10(
                        c, (False, True, False)))
                    results[f"{key} {label}"]["device_ms_g_w_alone"] = alone
                    print(f"[B10 {label}] shipped device ms, g_w alone: "
                          f"{alone:.4f}", flush=True)
                print(f"[{key} {label}] " + "; ".join(
                    f"{name} {' / '.join(f'{t:.4f}' for t in times[name])} "
                    f"ms, device "
                    f"{' / '.join(f'{t:.4f}' for t in dev_ms[name])}"
                    for name in runs) + f"; bitwise to shipped: {bitwise}",
                    flush=True)
    print(json.dumps(results))
    changed = [k for k, v in results.get("B8/B9 unchanged", {}).items()
               if k.endswith("sass equal") and not v]
    if changed:
        sys.exit(f"b7_b10_variants: machine code changed: {changed}")


if __name__ == "__main__":
    main()
