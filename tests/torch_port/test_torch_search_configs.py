"""Port parity of the configurations the search kernels do not take, and
of the rest of the lattice, gather and flow layers they need:
NonLocalSearch's lattice route (pt 2, reflect_bounds=False, strideQ,
off_Hq/off_Wq, ws_interior, fractional dilation) against the JAX
package's lattice engine (impl="lattice"); NonLocalGather with
reflect_bounds=False; accumulate_flow, run_accumulate_flow,
extract_search_from_accumulated, index_grid and non_local_inds; the
geometry helpers reflect_bounds_clip, pixel_grid and flat_gather; and the
port's lattice and gather against the numpy oracles
stnls_tpu/testing/{nls_gt,agg_gt}.py.

Inputs come from numpy seed 0 (the fixture). Outputs and offsets agree
within atol = rtol = 1e-4 (the float64 oracles within 2e-4, as the JAX
package's own tests hold its lattice to them), gradients within 1e-4 *
max|ref|, flow gradients on flows off integers.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import stnls_tpu
import stnls_tpu_torch
from stnls_tpu.testing.nls_gt import nls_search_gt
from stnls_tpu.testing.agg_gt import gather_stack_gt
from stnls_tpu_torch.search.non_local_search import search_route

from torch_port_helpers import to_torch, to_np, assert_close, \
    assert_grad_close

B, HD, T, F, H, W = 1, 2, 3, 2, 10, 10
WT = 1


def _search_both(rng, kw, k=4, ws=3, ps=3, T_=T, wt=WT):
    v0 = rng.standard_normal((B, T_, HD * F, H, W)).astype(np.float32)
    v1 = rng.standard_normal((B, T_, HD * F, H, W)).astype(np.float32)
    W_t = min(2 * wt + 1, T_)
    flows = (1.5 * rng.standard_normal((B, T_, W_t - 1, 2, H, W)) + 0.3) \
        .astype(np.float32)
    jsearch = stnls_tpu.search.NonLocalSearch(ws, wt, ps, k, impl="lattice",
                                              nheads=HD, **kw)
    tsearch = stnls_tpu_torch.search.NonLocalSearch(ws, wt, ps, k,
                                                    nheads=HD, **kw)
    tins = [to_torch(x, True) for x in (v0, v1, flows)]
    td, ti = tsearch(*tins)
    gd = rng.standard_normal(tuple(td.shape)).astype(np.float32)
    gi = rng.standard_normal(tuple(ti.shape)).astype(np.float32)

    def jloss(a, b, f):
        d, i = jsearch(a, b, f)
        return (jnp.sum(jnp.where(jnp.isfinite(d), d * gd, 0.))
                + jnp.sum(i * gi)), (d, i)

    (_, (jd, ji)), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(
        *map(jnp.asarray, (v0, v1, flows)))
    loss = torch.where(td.isfinite(), td * torch.from_numpy(gd), 0.).sum() \
        + (ti * torch.from_numpy(gi)).sum()
    tg = torch.autograd.grad(loss, tins, allow_unused=True,
                             materialize_grads=True)
    return tsearch, (jd, ji, jg), (td, ti, tg)


LATTICE_ONLY = [
    (dict(pt=2), dict(T_=4, wt=2)),
    (dict(reflect_bounds=False), {}),
    (dict(reflect_bounds=False, itype="int", dist_type="prod"), {}),
    (dict(strideQ=2, stride0=1), dict(ps=2)),
    (dict(off_Hq=1, off_Wq=2), dict(ps=1)),
    (dict(off_Hq=-1, off_Wq=1, itype="int"), {}),
    (dict(ws_interior=3, itype="int"), dict(ws=5)),
    (dict(ws_interior=3), dict(ws=5)),
    (dict(reflect_bounds=False, self_action="anchor_each",
          topk_mode="each"), dict(k=2)),
]


@pytest.mark.parametrize("kw,size", LATTICE_ONLY)
def test_lattice_only_configs_match_jax(rng, kw, size):
    kw = dict(dict(stride1=1, self_action="anchor"), **kw)
    tsearch, (jd, ji, jg), (td, ti, tg) = _search_both(rng, kw, **size)
    assert search_route(tsearch.cfg, (B, HD, T, F, H, W)) == "lattice"
    assert tuple(td.shape) == jd.shape and tuple(ti.shape) == ji.shape
    assert_close(td, jd, "dists")
    assert_close(ti, np.asarray(ji, np.float32), "inds")
    for a, b, name in zip(tg, jg, ("g_vid0", "g_vid1", "g_flows")):
        assert_grad_close(a, b, name)


def test_fractional_dilation_raises_as_jax(rng):
    """Fractional dilation puts the query patch off the pixel grid: the
    JAX lattice's gather refuses it (TypeError at the call), and so does
    the port's, on the lattice route."""
    v = rng.standard_normal((B, T, HD * F, H, W)).astype(np.float32)
    fl = np.zeros((B, T, 2, 2, H, W), np.float32)
    kw = dict(nheads=HD, dilation=1.5)
    tsearch = stnls_tpu_torch.search.NonLocalSearch(3, 1, 3, 4, **kw)
    assert search_route(tsearch.cfg, (B, HD, T, F, H, W)) == "lattice"
    with pytest.raises(TypeError):
        stnls_tpu.search.NonLocalSearch(3, 1, 3, 4, impl="lattice", **kw)(
            *map(jnp.asarray, (v, v, fl)))
    with pytest.raises(TypeError):
        tsearch(*map(to_torch, (v, v, fl)))


@pytest.mark.parametrize("itype,heads", [("float", HD), ("int", 1)])
def test_gather_no_reflect_matches_jax(rng, itype, heads):
    """NonLocalGather with reflect_bounds=False (reads outside the frame
    are 0): the stack and its gradients into the video, the weights and
    (float) the offsets, through the agg module. The int path runs one
    head here: stnls_tpu's int mask there broadcasts a head's mask over
    the channels (it multiplies [B,HD,K,...] into [B,HD,C,K,...] from the
    right), so with more heads its stack is not the gather's; the port's
    is held to the numpy oracle at two heads in
    test_gather_matches_numpy_oracle."""
    vid = rng.standard_normal((B, heads, T, F, H, W)).astype(np.float32)
    K = 3
    w = rng.standard_normal((B, heads, T, H, W, K)).astype(np.float32)
    fl = np.empty((B, heads, T, H, W, K, 3), np.float32)
    fl[..., 0] = rng.integers(-1, 2, fl.shape[:-1])
    fl[..., 1:] = 2.5 * rng.standard_normal(fl.shape[:-1] + (2,)) + 0.3
    cfg = {"agg_name": "gather", "ps": 3, "stride0": 1, "itype": itype,
           "reflect_bounds": False}
    jagg = stnls_tpu.agg.init(cfg)
    tagg = stnls_tpu_torch.agg.init(cfg)
    tins = [to_torch(x, True) for x in (vid, w, fl)]
    out = tagg(*tins)
    g = rng.standard_normal(tuple(out.shape)).astype(np.float32)
    jins = tuple(map(jnp.asarray, (vid, w, fl)))
    jg = jax.grad(lambda *a: jnp.sum(jagg(*a) * g), argnums=(0, 1, 2))(
        *jins)
    tg = torch.autograd.grad((out * torch.from_numpy(g)).sum(), tins,
                             allow_unused=True, materialize_grads=True)
    assert_close(out, jagg(*jins), "stack")
    for a, b, name in zip(tg, jg, ("g_vid", "g_weights", "g_flows")):
        assert_grad_close(a, b, name)
    # the reflecting stack differs at the borders
    ref = stnls_tpu_torch.agg.init(dict(cfg, reflect_bounds=True))(
        *map(to_torch, (vid, w, fl)))
    assert not torch.allclose(ref, out)


def test_accumulate_flow_matches_jax(rng):
    """accumulate_flow's walks, run_accumulate_flow, the search window cut
    out of them (equal to search_flow at every frame) and index_grid;
    gradients into both flows."""
    Tf, Hf = 5, 6
    ff = (1.5 * rng.standard_normal((B, Tf, 2, Hf, Hf))).astype(np.float32)
    bf = (1.5 * rng.standard_normal((B, Tf, 2, Hf, Hf))).astype(np.float32)
    tf, tb = to_torch(ff, True), to_torch(bf, True)
    acc = stnls_tpu_torch.nn.accumulate_flow(tf, tb, stride0=1)
    jacc = stnls_tpu.nn.accumulate_flow(jnp.asarray(ff), jnp.asarray(bf),
                                        stride0=1)
    assert_close(acc.fflow, jacc.fflow, "pfflow")
    assert_close(acc.bflow, jacc.bflow, "pbflow")
    run = stnls_tpu_torch.nn.run_accumulate_flow(tf, tb, stride0=2)
    jrun = stnls_tpu.nn.run_accumulate_flow(jnp.asarray(ff),
                                            jnp.asarray(bf), stride0=2)
    assert_close(run.fflow, jrun.fflow, "strided pfflow")
    sf = stnls_tpu_torch.nn.search_flow(tf, tb, 1, 1)
    ex = stnls_tpu_torch.nn.extract_search_from_accumulated(
        acc.fflow, acc.bflow, 1, Tf)
    assert_close(ex, stnls_tpu.nn.extract_search_from_accumulated(
        jacc.fflow, jacc.bflow, 1, Tf), "extract")
    assert_close(ex, sf, "extract vs search_flow")
    g = rng.standard_normal(tuple(acc.fflow.shape)).astype(np.float32)

    def jloss(a, b):
        out = stnls_tpu.nn.accumulate_flow(a, b, stride0=1)
        return jnp.sum(out.fflow * g) + jnp.sum(out.bflow ** 2)

    jgf, jgb = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(ff),
                                               jnp.asarray(bf))
    loss = (acc.fflow * torch.from_numpy(g)).sum() + acc.bflow.pow(2).sum()
    tgf, tgb = torch.autograd.grad(loss, (tf, tb))
    assert_grad_close(tgf, jgf, "g_fflow")
    assert_grad_close(tgb, jgb, "g_bflow")
    assert_close(stnls_tpu_torch.nn.index_grid(3, 4, 5),
                 stnls_tpu.nn.index_grid(3, 4, 5), "index_grid")


@pytest.mark.parametrize("stride0,stride1", [(1, 1), (2, 0.5)])
def test_non_local_inds_matches_jax(rng, stride0, stride1):
    ff = (1.5 * rng.standard_normal((B, T, 2, 8, 8))).astype(np.float32)
    bf = (1.5 * rng.standard_normal((B, T, 2, 8, 8))).astype(np.float32)
    out = stnls_tpu_torch.nn.non_local_inds(to_torch(ff), to_torch(bf), 3,
                                            1, stride0, stride1)
    ref = stnls_tpu.nn.non_local_inds(jnp.asarray(ff), jnp.asarray(bf), 3,
                                      1, stride0, stride1)
    assert tuple(out.shape) == ref.shape
    assert_close(out, ref, "non_local_inds")


def test_geometry_helpers_match_jax(rng):
    from stnls_tpu.ops import geometry as jg
    from stnls_tpu_torch.ops import geometry as tg
    v = np.arange(-12, 13, dtype=np.float32) * 0.75
    for L in (3, 5, 8):
        assert_close(tg.reflect_bounds_clip(to_torch(v), L),
                     jg.reflect_bounds_clip(jnp.asarray(v), L), f"clip {L}")
        vi = np.arange(-12, 13, dtype=np.int32)
        np.testing.assert_array_equal(
            to_np(tg.reflect_bounds_clip(torch.from_numpy(vi), L)),
            np.asarray(jg.reflect_bounds_clip(jnp.asarray(vi), L)))
    for a, b in zip(tg.pixel_grid(3, 4, 5, 2, 7, 9),
                    jg.pixel_grid(3, 4, 5, 2, 7, 9)):
        np.testing.assert_array_equal(to_np(a), np.asarray(b))
    frames = rng.standard_normal((2, 3, 20)).astype(np.float32)
    idx = rng.integers(0, 20, (2, 3, 7))
    valid = rng.random((2, 3, 7)) > 0.3
    assert_close(tg.flat_gather(to_torch(frames), torch.from_numpy(idx),
                                fill=-1., valid=torch.from_numpy(valid)),
                 jg.flat_gather(jnp.asarray(frames), jnp.asarray(idx),
                                fill=-1., valid=jnp.asarray(valid)),
                 "flat_gather")


ORACLE = [
    dict(ws=3, wt=1, ps=3, stride0=1, stride1=0.5, dist_type="prod",
         itype="float"),
    dict(ws=3, wt=2, ps=1, stride0=1, stride1=1, dist_type="l2",
         itype="float", pt=2),
    dict(ws=3, wt=1, ps=3, stride0=2, stride1=1, dist_type="l2",
         itype="int", reflect_bounds=False),
    dict(ws=3, wt=1, ps=2, stride0=1, stride1=1, dist_type="l2",
         itype="float", strideQ=2, off_Hq=1, off_Wq=2),
]


@pytest.mark.parametrize("cfg", ORACLE)
def test_lattice_matches_numpy_oracle(rng, cfg):
    """The port's lattice (ops/nls.nls_search_core) against the naive
    per-query loops of stnls_tpu/testing/nls_gt.py."""
    from stnls_tpu_torch.ops.nls import nls_search_core
    cfg = dict(cfg)
    Tn = 4 if cfg.get("pt", 1) > 1 else 3
    nH = (8 - 1) // cfg["stride0"] + 1
    v0 = rng.standard_normal((1, 1, Tn, 2, 8, 8)).astype(np.float32)
    v1 = rng.standard_normal((1, 1, Tn, 2, 8, 8)).astype(np.float32)
    W_t = min(2 * cfg["wt"] + 1, Tn)
    fl = (2 * rng.standard_normal((1, 1, Tn, W_t - 1, 2, nH, nH))) \
        .astype(np.float32)
    if cfg["itype"] == "int":
        fl = np.round(fl)
    kw = dict(cfg, reflect_bounds_=cfg.pop("reflect_bounds", True))
    gt_kw = dict(cfg, reflect_bounds=kw["reflect_bounds_"])
    d, i = nls_search_core(*map(to_torch, (v0, v1, fl)), **kw)
    d_gt, i_gt = nls_search_gt(v0, v1, fl, **gt_kw)
    valid = np.isfinite(d_gt)
    assert valid.any()
    np.testing.assert_array_equal(np.isfinite(to_np(d)), valid)
    np.testing.assert_allclose(to_np(d)[valid], d_gt[valid], rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(to_np(i).astype(np.float64), i_gt,
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("reflect,itype", [(True, "float"), (False, "float"),
                                           (False, "int")])
def test_gather_matches_numpy_oracle(rng, reflect, itype):
    """The gather stack against stnls_tpu/testing/agg_gt.py's loops, two
    heads."""
    from stnls_tpu_torch.ops.agg import nl_gather_stack
    K = 2
    vid = rng.standard_normal((1, 2, 3, 2, 8, 8)).astype(np.float32)
    w = rng.standard_normal((1, 2, 3, 8, 8, K)).astype(np.float32)
    fl = np.empty((1, 2, 3, 8, 8, K, 3), np.float32)
    fl[..., 0] = rng.integers(-1, 2, fl.shape[:-1])
    fl[..., 1:] = 2 * rng.standard_normal(fl.shape[:-1] + (2,))
    if itype == "int":
        fl = np.round(fl)
    out = nl_gather_stack(*map(to_torch, (vid, w, fl)), ps=3, stride0=1,
                          reflect_bounds_=reflect, itype=itype)
    gt = gather_stack_gt(vid, w, fl, 3, 1, reflect=reflect, itype=itype)
    np.testing.assert_allclose(to_np(out), gt, rtol=2e-4, atol=2e-4)
