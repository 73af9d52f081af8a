"""Slow tier: the port's plain versions against the TPU Pallas kernels
themselves, run in interpret mode with explicit budgets that leave no
out-of-budget entry (outliers == 0 is asserted, so the Pallas outputs are
exact). The Pallas kernels sum their taps in their own tile order, so
values agree to 3e-4 (the JAX package's own Pallas-vs-lattice tolerance),
and gradients to 3e-4 * max|g|. The backward checks hold the plain
versions of B2, B4, B6, B8 and B10 against the grads of the Pallas
kernels' own custom_vjps (B2 topk_bwd_pallas, B4 agg_bwd_pallas at the
Pallas cells, B6 vol_bwd_pallas through nls_pallas_volume's _vol_op, B8
and B10 through nl_scatter_add_pallas's and nl_pool_pallas's)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from stnls_tpu.ops.nls_pallas import nls_pallas_topk, nls_pallas_volume
from stnls_tpu.ops.agg_pallas import nl_gather_stack_pallas
from stnls_tpu.ops.agg_pallas_sp import nl_scatter_add_pallas, \
    nl_pool_pallas
from stnls_tpu_torch.ops.nls_cuda import nls_topk_plain, search_dists
from stnls_tpu_torch.ops.nls import search_centres
from stnls_tpu_torch.ops.nls_k import cells_geometry, search_aux, \
    aux_to_inds3
from stnls_tpu_torch.ops.nls_vol_cuda import search_volume
from stnls_tpu_torch.ops.agg_cuda import nl_gather_stack_plain, \
    _gather_bwd_plain
from stnls_tpu_torch.ops.agg_sp_cuda import nl_scatter_add_plain, \
    nl_pool_plain, _scatter_add_bwd_plain, _pool_bwd_plain

from torch_port_helpers import (
    to_torch, assert_close, assert_grad_close, assert_cells_match,
)

B, HD, T, F, H, W = 1, 1, 3, 4, 32, 32
WS, WT, PS, K = 3, 1, 3, 4
PALLAS_TOL = 3e-4


@pytest.mark.slow
def test_topk_plain_matches_pallas_topk(rng):
    v0 = rng.standard_normal((B, HD, T, F, H, W)).astype(np.float32)
    v1 = rng.standard_normal((B, HD, T, F, H, W)).astype(np.float32)
    flows = np.clip(1.5 * rng.standard_normal((B, HD, T, 2 * WT, 2, H, W)),
                    -1.5, 1.5).astype(np.float32)
    kw = dict(ws=WS, wt=WT, ps=PS, stride0=1, stride1=1, k=K, anchor=True,
              itype="float")
    d_p, _, c_p, outl = nls_pallas_topk(
        jnp.asarray(v0), jnp.asarray(v1), jnp.asarray(flows), flow_budget=4,
        spread_budget=8, interpret=True, **kw)
    assert int(jnp.sum(outl)) == 0
    d, cells = nls_topk_plain(to_torch(v0), to_torch(v1), to_torch(flows),
                              **kw)
    assert_cells_match(cells, c_p, d_p)
    assert_close(d, d_p, "dists", atol=PALLAS_TOL, rtol=PALLAS_TOL)


@pytest.mark.slow
def test_gather_plain_matches_pallas_gather(rng):
    vid = rng.standard_normal((B, HD, T, F, H, W)).astype(np.float32)
    weights = rng.random((B, HD, T, H, W, K)).astype(np.float32)
    dt = rng.integers(-1, 2, (B, HD, T, H, W, K))
    dhw = np.clip(1.5 * rng.standard_normal((2, B, HD, T, H, W, K)), -2, 2)
    flows = np.stack([dt, dhw[0], dhw[1]], -1).astype(np.float32)
    ref, outl = nl_gather_stack_pallas(
        jnp.asarray(vid), jnp.asarray(weights), jnp.asarray(flows), ps=PS,
        stride0=1, budget=4, spread=8, interpret=True)
    assert int(jnp.sum(outl)) == 0
    out = nl_gather_stack_plain(to_torch(vid), to_torch(weights),
                                to_torch(flows), ps=PS, stride0=1)
    assert_close(out, ref, "stack", atol=PALLAS_TOL, rtol=PALLAS_TOL)


@pytest.mark.slow
def test_search_backward_plain_matches_pallas_topk_bwd(rng):
    v0 = rng.standard_normal((B, HD, T, F, H, W)).astype(np.float32)
    v1 = rng.standard_normal((B, HD, T, F, H, W)).astype(np.float32)
    flows = np.clip(1.5 * rng.standard_normal((B, HD, T, 2 * WT, 2, H, W)),
                    -1.5, 1.5).astype(np.float32)
    kw = dict(ws=WS, wt=WT, ps=PS, stride0=1, stride1=1, k=K, anchor=True,
              itype="float")

    def pallas_dists(a, b, f):
        d, _, cells, outl = nls_pallas_topk(
            a, b, f, flow_budget=4, spread_budget=8, interpret=True, **kw)
        return d, (cells, outl)

    d_p, vjp, (c_p, outl) = jax.vjp(pallas_dists, jnp.asarray(v0),
                                    jnp.asarray(v1), jnp.asarray(flows),
                                    has_aux=True)
    assert int(jnp.sum(outl)) == 0
    gd = rng.standard_normal(d_p.shape).astype(np.float32)
    jg = vjp(jnp.asarray(gd))

    tv0, tv1, tfl = to_torch(v0, True), to_torch(v1, True), \
        to_torch(flows, True)
    geo = cells_geometry(tfl, torch.from_numpy(np.asarray(c_p)), H=H, W=W,
                         ws=WS, wt=WT, stride0=1, stride1=1)
    td = search_dists(tv0, tv1, geo["prop_h"], geo["prop_w"], to_torch(d_p),
                      geo["tj_k"], geo["valid"], ps=PS)
    tg = torch.autograd.grad((td * torch.from_numpy(gd)).sum(),
                             (tv0, tv1, tfl))
    for a, b, name in zip(tg, jg, ("g_vid0", "g_vid1", "g_flows")):
        assert_grad_close(a, b, name, tol=PALLAS_TOL)


@pytest.mark.slow
def test_gather_backward_plain_matches_pallas_agg_bwd(rng):
    vid = rng.standard_normal((B, HD, T, F, H, W)).astype(np.float32)
    weights = rng.random((B, HD, T, H, W, K)).astype(np.float32)
    dt = rng.integers(-1, 2, (B, HD, T, H, W, K))
    dhw = np.clip(1.5 * rng.standard_normal((2, B, HD, T, H, W, K)), -2, 2)
    flows = np.stack([dt, dhw[0], dhw[1]], -1).astype(np.float32)
    stack, vjp, outl = jax.vjp(
        lambda v, w, f: nl_gather_stack_pallas(
            v, w, f, ps=PS, stride0=1, budget=4, spread=8, interpret=True),
        jnp.asarray(vid), jnp.asarray(weights), jnp.asarray(flows),
        has_aux=True)
    assert int(jnp.sum(outl)) == 0
    g = rng.standard_normal(stack.shape).astype(np.float32)
    jg = vjp(jnp.asarray(g))
    cfg = dict(ps=PS, stride0=1, pt=1, dilation=1, reflect_bounds=True,
               use_adj=False, itype="float")
    tg = _gather_bwd_plain(to_torch(vid), to_torch(weights), to_torch(flows),
                           torch.from_numpy(g), cfg, (True, True, True))
    for a, b, name in zip(tg, jg, ("g_vid", "g_weights", "g_flows")):
        # dt is an integer frame offset: no gradient on either side
        assert_grad_close(a, b, name, tol=PALLAS_TOL)


def _pallas_volume_inputs(rng):
    """Flows within the budget and off the bilinear kinks: a clip at
    +-1.5 would put a third of them where the stride1=0.5 lattice hits
    integer coordinates and the flow derivative jumps (the two engines
    then take different one-sided derivatives)."""
    v0 = rng.standard_normal((B, HD, T, F, H, W)).astype(np.float32)
    v1 = rng.standard_normal((B, HD, T, F, H, W)).astype(np.float32)
    flows = (1.4 * np.tanh(rng.standard_normal((B, HD, T, 2 * WT, 2, H, W)))
             ).astype(np.float32)
    return v0, v1, flows


@pytest.mark.slow
@pytest.mark.parametrize("dist_type", ["l2", "prod"])
def test_volume_plain_matches_pallas_volume(rng, dist_type):
    """B5's plain version (lattice_search at the flows' centres) and the
    offsets of every cell against nls_pallas_volume's _vol_op."""
    v0, v1, flows = _pallas_volume_inputs(rng)
    kw = dict(ws=WS, wt=WT, ps=PS, stride0=1, stride1=0.5,
              dist_type=dist_type, itype="float")
    d_p, i3_p, outl = nls_pallas_volume(
        jnp.asarray(v0), jnp.asarray(v1), jnp.asarray(flows), flow_budget=4,
        spread_budget=8, interpret=True, **kw)
    assert int(jnp.sum(outl)) == 0
    tfl = to_torch(flows)
    ctr_h, ctr_w = search_centres(v0.shape, tfl, wt=WT, stride0=1)
    d = search_volume(to_torch(v0), to_torch(v1), ctr_h, ctr_w, **kw)
    assert_close(d, d_p, "volume", atol=PALLAS_TOL, rtol=PALLAS_TOL)
    aux = search_aux(v0.shape, tfl, ws=WS, wt=WT, stride0=1, stride1=0.5)
    assert_close(aux_to_inds3(aux, d.shape), i3_p, "inds3")


@pytest.mark.slow
def test_volume_backward_plain_matches_pallas_vol_bwd(rng):
    """B6's plain version, chained to the flows through the centres,
    against the grads of nls_pallas_volume's custom_vjp (vol_bwd_pallas)
    on a dense cotangent."""
    v0, v1, flows = _pallas_volume_inputs(rng)
    kw = dict(ws=WS, wt=WT, ps=PS, stride0=1, stride1=0.5, itype="float")

    def pallas_volume(a, b, f):
        d, _, outl = nls_pallas_volume(a, b, f, flow_budget=4,
                                       spread_budget=8, interpret=True, **kw)
        return d, outl

    d_p, vjp, outl = jax.vjp(pallas_volume, jnp.asarray(v0), jnp.asarray(v1),
                             jnp.asarray(flows), has_aux=True)
    assert int(jnp.sum(outl)) == 0
    gd = rng.standard_normal(d_p.shape).astype(np.float32)
    jg = vjp(jnp.asarray(gd))
    tv0, tv1, tfl = to_torch(v0, True), to_torch(v1, True), \
        to_torch(flows, True)
    ctr_h, ctr_w = search_centres(v0.shape, tfl, wt=WT, stride0=1)
    td = search_volume(tv0, tv1, ctr_h, ctr_w, **kw)
    tg = torch.autograd.grad((td * torch.from_numpy(gd)).sum(),
                             (tv0, tv1, tfl))
    for a, b, name in zip(tg, jg, ("g_vid0", "g_vid1", "g_flows")):
        assert_grad_close(a, b, name, tol=PALLAS_TOL)


@pytest.mark.slow
def test_ps1_plain_matches_pallas_topk_and_volume(rng):
    """At (ps, F a head) = (1, 2), the 1080p alignment search's: B1's plain
    version against nls_pallas_topk and B5's against nls_pallas_volume."""
    v0 = rng.standard_normal((B, HD, T, 2, H, W)).astype(np.float32)
    v1 = rng.standard_normal((B, HD, T, 2, H, W)).astype(np.float32)
    flows = (1.4 * np.tanh(rng.standard_normal((B, HD, T, 2 * WT, 2, H, W)))
             ).astype(np.float32)
    kw = dict(ws=WS, wt=WT, ps=1, stride0=1, stride1=1, itype="float")
    pallas = dict(flow_budget=4, spread_budget=8, interpret=True)
    args = (jnp.asarray(v0), jnp.asarray(v1), jnp.asarray(flows))
    d_p, _, c_p, outl = nls_pallas_topk(*args, k=K, anchor=True, **pallas,
                                        **kw)
    assert int(jnp.sum(outl)) == 0
    targs = (to_torch(v0), to_torch(v1), to_torch(flows))
    d, cells = nls_topk_plain(*targs, k=K, anchor=True, **kw)
    assert_cells_match(cells, c_p, d_p)
    assert_close(d, d_p, "topk dists", atol=PALLAS_TOL, rtol=PALLAS_TOL)
    dv_p, _, outl = nls_pallas_volume(*args, **pallas, **kw)
    assert int(jnp.sum(outl)) == 0
    ctr_h, ctr_w = search_centres(v0.shape, targs[2], wt=WT, stride0=1)
    dv = search_volume(*targs[:2], ctr_h, ctr_w, **kw)
    assert_close(dv, dv_p, "volume", atol=PALLAS_TOL, rtol=PALLAS_TOL)


def _sp_pallas_inputs(rng, stride0):
    """Integer offsets within the Pallas kernels' budgets (|dh|, |dw| <= 2,
    |dt| <= 1), as the JAX package's own tests of these kernels take."""
    nH = (H - 1) // stride0 + 1
    vid = rng.standard_normal((B, HD, T, F, H, W)).astype(np.float32)
    weights = rng.random((B, HD, T, nH, nH, K)).astype(np.float32)
    flows = rng.integers(-2, 3, (B, HD, T, nH, nH, K, 3)).astype(np.float32)
    flows[..., 0] = np.clip(flows[..., 0], -1, 1)
    return vid, weights, flows


def _check_sp_plain_vs_pallas(rng, pallas, plain, plain_bwd, cfg, stride0):
    """Forward of the plain version and its backward (on a seeded
    cotangent) against the Pallas kernel's output and custom_vjp grads."""
    vid, weights, flows = _sp_pallas_inputs(rng, stride0)
    out, vjp, outl = jax.vjp(lambda v, w: pallas(v, w, jnp.asarray(flows)),
                             jnp.asarray(vid), jnp.asarray(weights),
                             has_aux=True)
    assert int(jnp.sum(outl)) == 0
    tv, tw, tf = to_torch(vid), to_torch(weights), to_torch(flows)
    assert_close(plain(tv, tw, tf, **cfg), out, "out", atol=PALLAS_TOL,
                 rtol=PALLAS_TOL)
    g = rng.standard_normal(out.shape).astype(np.float32)
    jg = vjp(jnp.asarray(g))
    tg = plain_bwd(tv, tw, tf, torch.from_numpy(g), cfg, (True, True, False))
    for a, b, name in zip(tg, jg, ("g_vid", "g_weights")):
        assert_grad_close(a, b, name, tol=PALLAS_TOL)


@pytest.mark.slow
@pytest.mark.parametrize("stride0", [1, 2])
def test_scatter_add_plain_matches_pallas(rng, stride0):
    """B7's and B8's plain versions against nl_scatter_add_pallas."""
    cfg = dict(ps=PS, strideIn=stride0, strideOut=stride0, pt=1, dilation=1,
               reflect_bounds=True, use_adj=False, outH=H, outW=W)
    _check_sp_plain_vs_pallas(
        rng, lambda v, w, f: nl_scatter_add_pallas(
            v, w, f, ps=PS, stride0=stride0, budget=8, spread=12,
            interpret=True),
        nl_scatter_add_plain, _scatter_add_bwd_plain, cfg, stride0)


@pytest.mark.slow
def test_pool_plain_matches_pallas(rng):
    """B9's and B10's plain versions against nl_pool_pallas."""
    cfg = dict(ps=PS, stride0=1, pt=1, dilation=1, reflect_bounds=True,
               use_adj=False)
    _check_sp_plain_vs_pallas(
        rng, lambda v, w, f: nl_pool_pallas(v, w, f, ps=PS, budget=4,
                                            spread=8, interpret=True),
        nl_pool_plain, _pool_bwd_plain, cfg, 1)
