"""Search micro-benchmark: the twin of benchmarks/search_bench.py.

The same shapes, seeds and sequence: NonLocalSearch with itype "float"
and with itype "int" (512x512, T 3, 3 heads of F 9, ws 21, wt 3, ps 7,
K 10, stride0 1, self_action "anchor"; --small: 128x128, ws 9, wt 1,
ps 3), then a RefineSearch (wr 3) on the float search's offsets. Each
line prints the time of a call over `reps` calls (5, as the original) and
the peak device memory of those calls; one more line times the refine's
forward and backward, whose backward is the search backward kernel (B2).

Run on the card: python -m stnls_tpu_torch.search_bench [--small]
[--device cuda]. On "cpu" the kernels' plain versions run and no memory
is read.
"""

import argparse
import time

import numpy as np
import torch

from stnls_tpu_torch.nn import search_flow
from stnls_tpu_torch.ops import nls_cuda
from stnls_tpu_torch.search import NonLocalSearch, RefineSearch

FULL = dict(B=1, T=3, F=9, H=512, W=512, ws=21, wt=3, ps=7, k=10, HD=3)
SMALL = dict(B=1, T=3, F=9, H=128, W=128, ws=9, wt=1, ps=3, k=10, HD=3)


def make_inputs(cfg, device):
    """The video [B,T,F*HD,H,W] and the search flows from numpy seed 0,
    drawn in the original's order."""
    rng = np.random.default_rng(0)
    B, T, F, H, W, HD = (cfg[key] for key in ("B", "T", "F", "H", "W", "HD"))
    vid = torch.from_numpy(rng.standard_normal((B, T, F * HD, H, W))
                           .astype(np.float32)).to(device)
    fflow, bflow = (torch.from_numpy(rng.standard_normal((B, T, 2, H, W))
                                     .astype(np.float32)).to(device)
                    for _ in range(2))
    return vid, search_flow(fflow, bflow, cfg["wt"], 1)


def make_searches(cfg):
    """The original's three searches: nls, nls_int and the refine."""
    kw = dict(nheads=cfg["HD"], stride0=1, self_action="anchor")
    args = (cfg["ws"], cfg["wt"], cfg["ps"], cfg["k"])
    return {"nls": NonLocalSearch(*args, itype="float", **kw),
            "nls_int": NonLocalSearch(*args, itype="int", **kw),
            "refine": RefineSearch(cfg["ws"], cfg["wt"], wr=3, k=cfg["k"],
                                   ps=cfg["ps"], nheads=cfg["HD"], stride0=1,
                                   itype="float")}


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def timed(fn, device, reps):
    """(ms a call over `reps` calls after one warm-up, peak GB of those
    calls or None off the card, the last output)."""
    out = fn()
    _sync(device)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    _sync(device)
    ms = (time.perf_counter() - t0) / reps * 1e3
    peak = torch.cuda.max_memory_allocated(device) / 1e9 if cuda else None
    return ms, peak, out


def run(small=False, device="cuda", reps=5, log=print, cfg=None):
    """Run the sequence; returns {name: dict(ms, peak_gb, b1, b2)} with the
    launches of B1 and B2 in that name's timed calls (warm-up included),
    and the refine's inputs and outputs under "data". `cfg` replaces the
    FULL / SMALL sizes (the tests run a tiny one)."""
    cfg = cfg or (SMALL if small else FULL)
    vid, flows = make_inputs(cfg, device)
    searches = make_searches(cfg)
    res = {}

    def record(name, fn):
        b1, b2 = nls_cuda.nls_topk.launches, nls_cuda.nls_topk_bwd.launches
        ms, peak, out = timed(fn, device, reps)
        res[name] = dict(ms=ms, peak_gb=peak,
                         b1=nls_cuda.nls_topk.launches - b1,
                         b2=nls_cuda.nls_topk_bwd.launches - b2)
        mem = "n/a" if peak is None else f"{peak:.2f} GB"
        log(f"{name:14s} {ms:9.2f} ms  mem {mem}")
        return out

    with torch.no_grad():
        for name in ("nls", "nls_int"):
            record(name, lambda s=searches[name]: s(vid, vid, flows))
        _, inds = searches["nls"](vid, vid, flows)
        given = inds.float()
        d_ref, i_ref = record("refine", lambda: searches["refine"](
            vid, vid, given))

    def fwd_bwd():
        v = vid.detach().requires_grad_()
        fk = given.detach().requires_grad_()
        d, _ = searches["refine"](v, v, fk)
        return torch.autograd.grad(
            torch.where(d.isfinite(), d, 0.).sum(), (v, fk))

    record("refine fwd+bwd", fwd_bwd)
    res["data"] = dict(vid=vid, flows=flows, given=given, dists=d_ref,
                       inds=i_ref, cfg=cfg, searches=searches)
    return res


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--small", action="store_true")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--reps", type=int, default=5)
    args = parser.parse_args(argv)
    run(args.small, args.device, args.reps)


if __name__ == "__main__":
    main()
