"""Aggregation micro-benchmark: the twin of benchmarks/agg_bench.py.

The same shapes, seeded inputs and sequence: B 1, 2 heads of F 8, T 3,
512x512, K 10, ps 7 (--small: 128x128, ps 3); the video, uniform [0, 1)
weights and offsets round(3 * normal) drawn in that order from numpy's
default_rng(0); then each of five aggregators (NonLocalGather float and
int, NonLocalGatherAdd, NonLocalScatterAdd, PooledPatchSum) once to warm
up and 5 times inside the port's RecordIt (utils.bench), which
synchronises the card around the calls and snaps its memory. Each line
prints the time of a call, the memory in use after the calls (the
original's figure) and their peak. On the card the gathers and the
gather-add run B3, the scatter-add B7 and the pool B9.

Run on the card: python -m stnls_tpu_torch.agg_bench [--small]
[--device cuda]. On "cpu" the kernels' plain versions run and the memory
reads 0.
"""

import argparse

import numpy as np
import torch

from stnls_tpu_torch.agg import NonLocalGather, NonLocalGatherAdd, \
    NonLocalScatterAdd, PooledPatchSum
from stnls_tpu_torch.ops import agg_cuda, agg_sp_cuda
from stnls_tpu_torch.utils import mem
from stnls_tpu_torch.utils.bench import RecordIt

FULL = dict(B=1, HD=2, T=3, F=8, H=512, W=512, K=10, ps=7)
SMALL = dict(B=1, HD=2, T=3, F=8, H=128, W=128, K=10, ps=3)
NAMES = ("gather", "gather_int", "gather_add", "scatter_add", "pool")
REPS = 5


def make_inputs(cfg, device):
    """vid [B,HD,T,F,H,W], weights [B,HD,T,H,W,K] and offsets
    [B,HD,T,H,W,K,3] from numpy seed 0, drawn in the original's order."""
    rng = np.random.default_rng(0)
    B, HD, T, F, H, W, K = (cfg[key] for key in
                            ("B", "HD", "T", "F", "H", "W", "K"))
    arrays = (rng.standard_normal((B, HD, T, F, H, W)),
              rng.random((B, HD, T, H, W, K)),
              np.round(3 * rng.standard_normal((B, HD, T, H, W, K, 3))))
    return tuple(torch.from_numpy(x.astype(np.float32)).to(device)
                 for x in arrays)


def make_menu(ps):
    """The original's five aggregators, by name."""
    return {"gather": NonLocalGather(ps, 1, itype="float"),
            "gather_int": NonLocalGather(ps, 1, itype="int"),
            "gather_add": NonLocalGatherAdd(ps, 1, 1, itype="float"),
            "scatter_add": NonLocalScatterAdd(ps, 1, 1, itype="int"),
            "pool": PooledPatchSum(ps, 1)}


def launches():
    """The launch counts of B3, B7 and B9."""
    return {"B3": agg_cuda.nl_gather_stack.launches,
            "B7": agg_sp_cuda.nl_scatter_add.launches,
            "B9": agg_sp_cuda.nl_pool.launches}


def run(small=False, device="cuda", log=print):
    """Run the sequence; returns {name: dict(ms, mem_gb, peak_gb,
    launches)} with the time of a call, the memory in use after the
    name's calls and their peak (GB, 0 off the card) and the launches of
    B3, B7 and B9 in its calls (warm-up included), and under "data" the
    inputs, the last outputs and the menu."""
    cfg = SMALL if small else FULL
    vid, weights, flows = make_inputs(cfg, device)
    menu = make_menu(cfg["ps"])
    rec = RecordIt()
    res, outs = {}, {}
    with torch.no_grad():
        for name, agg in menu.items():
            before = launches()
            out = agg(vid, weights, flows)
            mem.reset_peak_gpu_stats()
            with rec(name):
                for _ in range(REPS):
                    out = agg(vid, weights, flows)
            after = launches()
            ms = rec.timers[name][-1] / REPS * 1e3
            in_use, peak = rec.mems[name]
            res[name] = dict(ms=ms, mem_gb=in_use, peak_gb=peak,
                             launches={k: after[k] - before[k]
                                       for k in after})
            log(f"{name:12s} {ms:9.2f} ms  mem {in_use:.2f} GB  "
                f"peak {peak:.2f} GB")
            outs[name] = out
    res["data"] = dict(vid=vid, weights=weights, flows=flows, outs=outs,
                       menu=menu, cfg=cfg)
    return res


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--small", action="store_true")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    run(args.small, args.device)


if __name__ == "__main__":
    main()
