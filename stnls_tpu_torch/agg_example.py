"""The aggregation family end to end: one search, four aggregators
(PyTorch twin of examples/agg_example.py).

The same (weights, offsets) from one NonLocalSearch drive NonLocalGather
(patch stack), NonLocalGatherAdd (weighted patch sum into a video),
NonLocalScatterAdd (the transposed aggregation, unnormalised) and
PooledPatchSum (ps-upsampled grid), each forward, then the gradients of
mean(out^2) to the video, the weights and the offsets. On CUDA tensors
this runs the search kernel B1, the gather kernels B3/B4 (Gather and
GatherAdd), ScatterAdd's B7/B8 and the pool's B9/B10; on CPU tensors their
plain versions.

Run: python -m stnls_tpu_torch.agg_example [--device cpu] [--size 32]
"""

import argparse
import time

import numpy as np
import torch

from stnls_tpu_torch.agg import NonLocalGather, NonLocalGatherAdd, \
    NonLocalScatterAdd, PooledPatchSum
from stnls_tpu_torch.nn.flow import search_flow
from stnls_tpu_torch.search.non_local_search import NonLocalSearch
from stnls_tpu_torch.search.utils import shape_vids

# examples/agg_example.py's configuration
CONFIG = dict(B=1, T=3, F=16, H=128, W=128, ws=5, wt=1, ps=3, K=8, HD=2)
NAMES = ("gather", "gather_add", "scatter_add", "pool")


def make_inputs(seed=0, *, B, T, F, H, W, device="cuda", **_):
    """The example's inputs from numpy seed `seed`: vid [B,T,F,H,W] and
    fflow, bflow [B,T,2,H,W] (2 * normal, clipped to +-4)."""
    rng = np.random.default_rng(seed)
    vid = rng.standard_normal((B, T, F, H, W))
    fflow = np.clip(2.0 * rng.standard_normal((B, T, 2, H, W)), -4, 4)
    bflow = np.clip(2.0 * rng.standard_normal((B, T, 2, H, W)), -4, 4)
    return tuple(torch.from_numpy(x.astype(np.float32)).to(device)
                 for x in (vid, fflow, bflow))


def search(vid, fflow, bflow, *, ws, wt, ps, K, HD, **_):
    """The example's search (anchor, float offsets) without gradient:
    (dists [B,HD,T,H,W,K], offsets [...,K,3])."""
    flows = search_flow(fflow, bflow, wt, 1)
    nls = NonLocalSearch(ws, wt, ps, K, nheads=HD, self_action="anchor",
                         itype="float")
    with torch.no_grad():
        return nls(vid, vid, flows)


def aggregators(ps):
    return {"gather": NonLocalGather(ps=ps, stride0=1),
            "gather_add": NonLocalGatherAdd(ps=ps, strideIn=1, strideOut=1),
            "scatter_add": NonLocalScatterAdd(ps=ps, strideIn=1,
                                              strideOut=1),
            "pool": PooledPatchSum(ps=ps, stride0=1)}


def aggregate(v6, weights, offsets, *, ps, names=NAMES, **_):
    """Each aggregator of `names` on (v6 [B,HD,T,F,H,W], weights,
    offsets), forward, then the gradients of mean(out^2). Returns {name:
    (out, g_vid, g_weights, g_offsets)}."""
    res, aggs = {}, aggregators(ps)
    for name in names:
        agg = aggs[name]
        leaves = [x.detach().clone().requires_grad_()
                  for x in (v6, weights, offsets)]
        out = agg(*leaves)
        # the rounded offsets of ScatterAdd and Pool get zeros
        grads = torch.autograd.grad(out.pow(2).mean(), leaves,
                                    allow_unused=True, materialize_grads=True)
        res[name] = (out.detach(),) + grads
    return res


def run(vid, fflow, bflow, cfg=CONFIG):
    """The example on the given inputs: (weights = softmax(-10 dists),
    offsets, v6, the aggregators' results as `aggregate` returns them)."""
    dists, offsets = search(vid, fflow, bflow, **cfg)
    weights = torch.softmax(-10. * dists, dim=-1)
    v6 = shape_vids(cfg["HD"], [vid])[0]
    return weights, offsets, v6, aggregate(v6, weights, offsets, **cfg)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--size", type=int, default=CONFIG["H"])
    args = parser.parse_args(argv)
    cfg = dict(CONFIG, H=args.size, W=args.size)
    inputs = make_inputs(0, device=args.device, **cfg)
    t0 = time.perf_counter()
    *_, res = run(*inputs, cfg)
    if args.device != "cpu":
        torch.cuda.synchronize()
    for name, (out, *grads) in res.items():
        ok = all(bool(x.isfinite().all()) for x in (out, *grads))
        print(f"{name:12s} out{tuple(out.shape)}  finite={ok}")
    print(f"({time.perf_counter() - t0:.1f}s on {args.device}, incl. the "
          "kernels' build)")
    return res


if __name__ == "__main__":
    main()
