"""Time B2 (stnls_tpu_torch/csrc/nls_topk_bwd.cu) and B3
(stnls_tpu_torch/csrc/agg_gather_fwd.cu) against variants of them on one
NVIDIA GPU, in turns (shipped, variants, variants in reverse, shipped),
each variant's outputs held to the shipped kernel's.

Run from the repository root:

    mkdir -p build/variants/previous
    git show REV:stnls_tpu_torch/csrc/nls_topk_bwd.cu \\
        > build/variants/previous/nls_topk_bwd.cu
    git show REV:stnls_tpu_torch/csrc/agg_gather_fwd.cu \\
        > build/variants/previous/agg_gather_fwd.cu
    python3 -m stnls_tpu_torch.b2_b3_variants [--previous DIR]

Variants:
  channels_last, planar (B3): the shipped kernel on a channels-last copy
    of the video, or on the planar video, whatever the stack's size (the
    wrapper picks by agg_cuda.CHANNELS_LAST_MIN).
  previous (with --previous DIR, default build/variants/previous when it
    holds the two sources): the kernels' sources of an earlier revision,
    with the C interface they had before the redesign: planar videos,
    B2 one thread per (query, slot) with scalar global atomics into both
    videos, B3 one thread per output element. Each is built alone into a
    library of its own; B2 is called as its wrapper called it then, B3
    through the shipped wrapper on the planar video.
  tile (B2): stnls_tpu_torch/csrc/variants/nls_topk_bwd_tile.cu, the
    shipped design with g_vid1 accumulated in shared-memory boxes of a
    query tile (B4's design) and flushed once.
  taps3 (B2): the shipped source with 3 query taps a register chunk in
    place of 9 at ps > 1 (fewer registers, the slot geometry recomputed
    and the position gradients added once a chunk).
Cases: B2 on a seeded cotangent at the slice's (ps, F) = (3, 8) on 128^2
(chip_smoke's kernel phase: its inputs and B1's cells) and at config 7's
(1, 2) (benchmarks/matrix.py, stnls_tpu_torch/matrix_steps.py) on the
270x480 crop of its inputs and on its whole 1080p frames, one head; B3 at
the slice (the search's softmax(-10 d) weights and offsets) and at config
1's int (1, 16) on 64^2. Prints the card's name and power limit, the
ptxas report of each variant's kernels, the CUDA-event medians in turns
and B2's global atomics per backward (the kernels' counts; the previous
design's, ps^2 * F * 5 per active (q, k), from the shapes). Exits
non-zero without a CUDA device. Imports nothing of JAX.
"""

import argparse
import ctypes
import json
import sys
from pathlib import Path

import numpy as np

from stnls_tpu_torch import variant_tools as vt

# B2's variants of the shipped C interface: (source under csrc/, text
# substitutions)
B2_VARIANTS = {"tile": ("variants/nls_topk_bwd_tile.cu", []),
               "taps3": ("nls_topk_bwd.cu", [("<VW, 9>", "<VW, 3>")])}
_P, _I = ctypes.c_void_p, ctypes.c_int
# the C interfaces of the kernels before the redesign
PREVIOUS = {"nls_topk_bwd": ("stnls_nls_topk_bwd", [_P] * 10 + [_I] * 17 + [_P]),
            "agg_gather_fwd": ("stnls_agg_gather_fwd",
                               [_P] * 4 + [_I] * 15 + [_P])}


def previous_b2(torch, fn, vid0, vid1, prop_h, prop_w, tj_k, valid, g_d,
                cfg):
    """The earlier B2 as its wrapper called it (whole videos)."""
    B, HD, T_v, F, H, W = vid0.shape
    nH, nW, K = g_d.shape[-3:]
    vid0, vid1 = vid0.contiguous(), vid1.contiguous()
    tj = torch.where(valid, tj_k, -1).to(torch.int32).contiguous()
    g = [torch.zeros_like(vid0), torch.zeros_like(vid1),
         torch.empty_like(prop_h), torch.empty_like(prop_w)]
    err = fn(vid0.data_ptr(), vid1.data_ptr(), prop_h.data_ptr(),
             prop_w.data_ptr(), tj.data_ptr(), g_d.data_ptr(),
             *(x.data_ptr() for x in g), B, HD, T_v, F, H, W, nH, nW, K,
             T_v, 0, cfg["ps"], cfg["stride0"], int(cfg["dilation"]),
             int(bool(cfg["use_adj"])), int(cfg["dist_type"] == "l2"),
             int(cfg["itype"] == "int"),
             torch.cuda.current_stream().cuda_stream)
    if err:
        sys.exit(f"b2_b3_variants: the previous B2 failed to launch ({err})")
    return tuple(g)


def b2_cases(torch, cs, dev):
    """{label: B2's arguments}: the slice's, config 7's crop and one head
    of its whole frames, each on a seeded cotangent at B1's cells."""
    from stnls_tpu_torch import matrix_steps as ms
    from stnls_tpu_torch.ops import nls_cuda
    from stnls_tpu_torch.ops.nls_k import cells_geometry
    out = {}
    rng = np.random.default_rng(cs.SEED)
    v0, v1, fl = cs.make_inputs(torch, rng, dev, B=1, HD=2, T=5, F=8,
                                H=128, W=128, wt=2)
    with torch.no_grad():
        _, cells = nls_cuda.nls_topk(v0, v1, fl, ws=5, wt=2, ps=3,
                                     stride0=1, stride1=0.5, k=10,
                                     anchor=True)
    geo = cells_geometry(fl, cells, H=128, W=128, ws=5, wt=2, stride0=1,
                         stride1=0.5)
    g_d = torch.from_numpy(rng.standard_normal(tuple(cells.shape))
                           .astype(np.float32)).to(dev)
    cfg = dict(ps=3, stride0=1, dist_type="l2", dilation=1, use_adj=False,
               itype="float")
    out["slice (3, 8) 128^2"] = (v0, v1, geo["prop_h"], geo["prop_w"],
                                 geo["tj_k"], geo["valid"], g_d, cfg)
    c7 = ms.config("align1080p_fwd+bwd")
    full = ms.make_inputs("align1080p_fwd+bwd", cs.SEED, device=dev)
    cfg = dict(cfg, ps=1)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 12)
    for label, inputs in (("config 7 (1, 2) 270x480 crop",
                           cs.crop_inputs(full, *cs.MATRIX_CROP)),
                          ("config 7 (1, 2) 1080p, head 0", full)):
        v, f = cs.matrix_search_args(torch, c7, inputs)
        v = v[:, :1].contiguous()
        H, W = v.shape[-2:]
        with torch.no_grad():
            _, cells = nls_cuda.nls_topk(v, v, f, ws=5, wt=3, ps=1,
                                         stride0=1, stride1=1, k=10,
                                         anchor=True)
        geo = cells_geometry(f, cells, H=H, W=W, ws=5, wt=3, stride0=1,
                             stride1=1)
        g_d = torch.randn(tuple(cells.shape), generator=gen, device=dev)
        out[label] = (v, v, geo["prop_h"], geo["prop_w"], geo["tj_k"],
                      geo["valid"], g_d, cfg)
        del cells, geo
    return out


def b3_cases(torch, cs, dev):
    """{label: (vid, weights, offsets, keywords)} of B3."""
    from stnls_tpu_torch.ops.nls_k import nls_dists_at_cells
    from stnls_tpu_torch.ops import nls_cuda
    out = {}
    rng = np.random.default_rng(cs.SEED)
    v0, v1, fl = cs.make_inputs(torch, rng, dev, B=1, HD=2, T=5, F=8,
                                H=128, W=128, wt=2)
    kw = dict(ws=5, wt=2, ps=3, stride0=1, stride1=0.5)
    with torch.no_grad():
        _, cells = nls_cuda.nls_topk(v0, v1, fl, k=10, anchor=True, **kw)
        d, (dt, dh, dw) = nls_dists_at_cells(v0, v1, fl, cells, **kw)
    w = torch.softmax(-10. * d, -1).contiguous()
    inds = torch.stack([dt, dh, dw], -1).contiguous()
    out["slice (3, 8) 128^2"] = (v1, w, inds, dict(ps=3, stride0=1))
    g = np.random.default_rng(cs.SEED + 1)
    vid = torch.from_numpy(g.standard_normal((1, 1, 3, 16, 64, 64))
                           .astype(np.float32)).to(dev)
    w = torch.from_numpy(g.random((1, 1, 3, 64, 64, 4))
                         .astype(np.float32)).to(dev)
    inds = torch.from_numpy(np.stack(
        [g.integers(-1, 2, (1, 1, 3, 64, 64, 4)),
         g.integers(-3, 4, (1, 1, 3, 64, 64, 4)),
         g.integers(-3, 4, (1, 1, 3, 64, 64, 4))], -1)
        .astype(np.float32)).to(dev)
    out["config 1 int (1, 16) 64^2"] = (vid, w, inds,
                                        dict(ps=1, stride0=1, itype="int"))
    # the multichip twin's gather: B=2, 4 query frames and halos of 4
    vid = torch.from_numpy(g.standard_normal((2, 2, 12, 8, 128, 128))
                           .astype(np.float32)).to(dev)
    w = torch.softmax(torch.from_numpy(
        -3 * g.random((2, 2, 12, 128, 128, 10)).astype(np.float32)).to(dev),
        -1).contiguous()
    inds = torch.from_numpy(np.stack(
        [g.integers(-2, 3, (2, 2, 12, 128, 128, 10)),
         2 * g.standard_normal((2, 2, 12, 128, 128, 10)),
         2 * g.standard_normal((2, 2, 12, 128, 128, 10))], -1)
        .astype(np.float32)).to(dev)
    out["twin shape (3, 8) 2x12 frames 128^2"] = (vid, w, inds,
                                                  dict(ps=3, stride0=1))
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--previous", default="build/variants/previous")
    parser.add_argument("--only", choices=("B2", "B3"),
                        help="time one kernel's variants only")
    args = parser.parse_args()
    root = Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        sys.exit("b2_b3_variants: no CUDA device; it times a GPU only")
    import chip_smoke as cs
    from stnls_tpu_torch.attn_step import cuda_ms
    from stnls_tpu_torch.ops import agg_cuda, cuda_lib, nls_cuda
    card = vt.card()
    print(card, flush=True)
    shipped = cuda_lib.load()
    out_dir = cuda_lib.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    dev = torch.device("cuda", 0)

    variants = {}
    for name, (src, subs) in B2_VARIANTS.items():
        path, log = vt.build(cuda_lib, cuda_lib.CSRC / src, out_dir,
                             f"b2_{name}", subs)
        print(f"{name}:\n{vt.ptxas_lines(log)}", flush=True)
        variants[name] = vt.Variant(shipped, path, "stnls_nls_topk_bwd")
    prev = {}
    prev_dir = Path(args.previous)
    if all((prev_dir / f"{k}.cu").exists() for k in PREVIOUS):
        for key, (sym, argtypes) in PREVIOUS.items():
            path, log = vt.build(cuda_lib, prev_dir / f"{key}.cu", out_dir,
                                 f"previous_{key}")
            print(f"previous {key}:\n{vt.ptxas_lines(log)}", flush=True)
            fn = getattr(ctypes.CDLL(str(path)), sym)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            prev[key] = fn
    else:
        print(f"no previous sources in {prev_dir}: timing the other variants "
              "only", flush=True)

    def swap(lib):
        vt.swap(cuda_lib, lib)

    results = {"card": card}
    libs = dict(shipped=shipped, **variants)
    b2_runs = {name: lambda a, lib=lib: (swap(lib), nls_cuda.nls_topk_bwd(
        *a))[1] for name, lib in libs.items()}
    if "nls_topk_bwd" in prev:
        b2_runs["previous"] = lambda a: previous_b2(
            torch, prev["nls_topk_bwd"], *a)
    for label, a in (b2_cases(torch, cs, dev) if args.only != "B3"
                     else {}).items():
        ref = b2_runs["shipped"](a)
        off = cs.off_integer(a[2]) & cs.off_integer(a[3])
        counts = {}
        for name, lib in libs.items():
            swap(lib)
            stats = torch.zeros(4, dtype=torch.int64, device=dev)
            nls_cuda.nls_topk_bwd(*a, stats=stats)
            counts[name] = stats.tolist()
        active = counts["shipped"][3]
        ps, F = a[7]["ps"], a[0].shape[3]
        counts["previous"] = active * ps * ps * F * 5
        order = list(b2_runs) + list(b2_runs)[::-1]
        times = {name: [] for name in b2_runs}
        for name in order:
            g = b2_runs[name](a)
            for gk, gr, what, m in zip(g, ref, ("g_vid0", "g_vid1",
                                                "g_prop_h", "g_prop_w"),
                                       (None, None, off, off)):
                if m is not None:
                    gk, gr = gk[m], gr[m]
                err = float((gk - gr).abs().max())
                if err > 1e-4 * float(gr.abs().max()):
                    sys.exit(f"b2_b3_variants: B2 {name} {what} differs at "
                             f"{label}: {err:.3e}")
            n = 3 if a[0].shape[-1] > 1000 else 10
            times[name].append(cuda_ms(lambda: b2_runs[name](a), n=n,
                                       warm=1))
        swap(shipped)
        results[f"B2 {label}"] = dict(ms=times, global_atomics={
            name: c if name == "previous" else sum(c[:2])
            for name, c in counts.items()}, active_pairs=active)
        print(f"[B2 {label}] " + "; ".join(
            f"{name} {' / '.join(f'{t:.3f}' for t in ts)} ms"
            for name, ts in times.items()) + "; global atomics a backward: "
            + ", ".join(f"{k} {v}" for k, v in
                        results[f"B2 {label}"]["global_atomics"].items())
            + f" ({active} active (q, k))", flush=True)
        del a, ref
    class PreviousB3:
        """The shipped library with B3's entry taken from the earlier
        source: the wrapper runs as shipped, on the planar video that the
        earlier kernel read, and the call
        drops the arguments its interface lacked (Fp, cl)."""

        def __init__(self, fn):
            self.fn = fn

        def stnls_agg_gather_fwd(self, *a):
            return self.fn(*a[:9], *a[10:20], a[21])

        def __getattr__(self, name):
            return getattr(shipped, name)

    cl_min = agg_cuda.CHANNELS_LAST_MIN

    def b3_layout(a, lib, channels_last):
        swap(lib)
        agg_cuda.CHANNELS_LAST_MIN = 0 if channels_last else sys.maxsize
        return agg_cuda.nl_gather_stack(*a[:3], **a[3])

    b3_runs = {"channels_last": lambda a: b3_layout(a, shipped, True),
               "planar": lambda a: b3_layout(a, shipped, False)}
    if "agg_gather_fwd" in prev:
        b3_runs["previous"] = lambda a, lib=PreviousB3(
            prev["agg_gather_fwd"]): b3_layout(a, lib, False)
    with torch.no_grad():
        for label, a in (b3_cases(torch, cs, dev) if args.only != "B2"
                         else {}).items():
            ref = b3_runs["channels_last"](a)
            order = list(b3_runs) + list(b3_runs)[::-1]
            times = {name: [] for name in b3_runs}
            for name in order:
                err = float((b3_runs[name](a) - ref).abs().max())
                if err > 1e-4 * max(1., float(ref.abs().max())):
                    sys.exit(f"b2_b3_variants: B3 {name} differs at "
                             f"{label}: {err:.3e}")
                times[name].append(cuda_ms(lambda: b3_runs[name](a)))
            agg_cuda.CHANNELS_LAST_MIN = cl_min
            swap(shipped)
            results[f"B3 {label}"] = dict(ms=times)
            print(f"[B3 {label}] " + "; ".join(
                f"{name} {' / '.join(f'{t:.3f}' for t in ts)} ms"
                for name, ts in times.items()), flush=True)
    print(json.dumps(results))


if __name__ == "__main__":
    main()
