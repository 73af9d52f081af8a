"""The port's public API against the JAX package's: the flop models
(`flops` of NonLocalSearch, NonLocalGather, SoftmaxNormalize and
NonLocalAttention), NonLocalSearch.radius, the functional search
`search.nls`, and NonLocalAttention's dropout (the attention weights are
never dropped, whatever `deterministic` says)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import stnls_tpu
import stnls_tpu_torch
from stnls_tpu.nn import NonLocalAttention as JAttention
from stnls_tpu.utils.config import ConfigDict as JConfigDict
from stnls_tpu_torch.convert import params_from_jax
from stnls_tpu_torch.nn import NonLocalAttention as TAttention
from stnls_tpu_torch.utils.config import ConfigDict

from torch_port_helpers import to_torch, assert_close, assert_cells_match

SEARCH_CASES = [
    dict(ws=5, wt=2, ps=3, k=10, nheads=2, stride1=0.5, itype="float"),
    dict(ws=9, wt=0, ps=1, k=9, nheads=1, itype="float"),
    dict(ws=5, wt=1, ps=1, k=-1, nheads=1, stride0=2, itype="int"),
    dict(ws=3, wt=3, ps=7, k=80, nheads=4, stride0=3, itype="int"),
]


@pytest.mark.parametrize("kw", SEARCH_CASES)
def test_search_flops_and_radius_match_jax(kw):
    kw = dict(kw)
    ws, wt = kw.pop("ws"), kw.pop("wt")
    jsearch = stnls_tpu.search.NonLocalSearch(ws, wt, **kw)
    tsearch = stnls_tpu_torch.search.NonLocalSearch(ws, wt, **kw)
    for shape in ((3, 16, 64, 64), (10, 4, 1080, 1920), (1, 2, 7, 5)):
        assert tsearch.flops(*shape) == jsearch.flops(*shape)
    assert tsearch.radius() == jsearch.radius() == ws


@pytest.mark.parametrize("ps,pt", [(1, 1), (3, 1), (7, 2)])
def test_gather_and_softmax_flops_match_jax(ps, pt):
    jg = stnls_tpu.agg.NonLocalGather(ps=ps, stride0=1, pt=pt)
    tg = stnls_tpu_torch.agg.NonLocalGather(ps=ps, stride0=1, pt=pt)
    for args in ((4096, 16, 1, 4), (2073600, 2, 2, 10)):
        assert tg.flops(*args) == jg.flops(*args)
    jn = stnls_tpu.normz.SoftmaxNormalize(10.)
    tn = stnls_tpu_torch.normz.SoftmaxNormalize(10.)
    assert tn.flops() == jn.flops() == 0
    assert tn.flops(1, 2, 3) == jn.flops(1, 2, 3)


def _attn_cfgs(drop_rate=0.):
    attn_cfg = {"nheads": 2, "embed_dim": 4, "use_attn_projection": True,
                "use_attn_flow": True}
    search_cfg = {"search_name": "nls", "ws": 5, "wt": 1, "ps": 3, "k": 6,
                  "nheads": 2, "stride0": 1, "stride1": 0.5,
                  "self_action": "anchor", "itype": "float",
                  "dist_type": "l2", "impl": "lattice"}
    normz_cfg = {"normz_name": "softmax", "normz_scale": 10,
                 "normz_drop_rate": drop_rate, "dist_type": "l2"}
    agg_cfg = {"agg_name": "gather", "ps": 3, "stride0": 1,
               "itype": "float"}
    return attn_cfg, search_cfg, normz_cfg, agg_cfg


def _jax_attention(cfgs, vid, ff, bf):
    jmodel = JAttention(*cfgs)
    jflows = JConfigDict(fflow=jnp.asarray(ff), bflow=jnp.asarray(bf))
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(vid), jflows)
    return jmodel, params, jflows


@pytest.mark.parametrize("H,W", [(24, 24), (128, 96)])
def test_attention_flops_match_jax(rng, H, W):
    cfgs = _attn_cfgs()
    vid = rng.standard_normal((1, 2, 8, 16, 16)).astype(np.float32)
    ff = np.zeros((1, 2, 2, 16, 16), np.float32)
    jmodel, params, _ = _jax_attention(cfgs, vid, ff, ff)
    jflops = jmodel.apply(params, H, W, method=JAttention.flops)
    tflops = TAttention(*cfgs).flops(H, W)
    assert tflops == jflops
    # every part adds its count: the search's and the gather's are in it
    assert tflops > 4 * H * W * 8 * 8


def test_attention_drops_no_attention_weight(rng):
    """normz_drop_rate = 0.5 and deterministic=False: the JAX module calls
    its normz without `deterministic`, so nothing is dropped; the port's
    output equals it."""
    cfgs = _attn_cfgs(drop_rate=0.5)
    B, T, H, W = 1, 3, 24, 24
    vid = rng.standard_normal((B, T, 8, H, W)).astype(np.float32)
    ff = (2 * rng.standard_normal((B, T, 2, H, W))).astype(np.float32)
    bf = (2 * rng.standard_normal((B, T, 2, H, W))).astype(np.float32)
    jmodel, params, jflows = _jax_attention(cfgs, vid, ff, bf)
    jout, _ = jmodel.apply(params, jnp.asarray(vid), jflows,
                           deterministic=False)
    tmodel = TAttention(*cfgs)
    tmodel.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    flows = ConfigDict(fflow=to_torch(ff), bflow=to_torch(bf))
    with torch.no_grad():
        tout, _ = tmodel(to_torch(vid), flows, deterministic=False)
        tref, _ = tmodel(to_torch(vid), flows)
    assert_close(tout, jout, "output, deterministic=False")
    assert torch.equal(tout, tref)


def test_functional_nls_matches_jax(rng):
    B, HD, T, F, H, W = 1, 2, 3, 4, 24, 24
    v0 = rng.standard_normal((B, T, HD * F, H, W)).astype(np.float32)
    v1 = rng.standard_normal((B, T, HD * F, H, W)).astype(np.float32)
    flows = (1.5 * rng.standard_normal((B, T, 2, 2, H, W))).astype(np.float32)
    kw = dict(ps=3, k=6, nheads=HD, stride1=0.5, self_action="anchor")
    jd, ji = stnls_tpu.search.nls(jnp.asarray(v0), jnp.asarray(v1),
                                  jnp.asarray(flows), 5, 1, **kw)
    td, ti = stnls_tpu_torch.search.nls(to_torch(v0), to_torch(v1),
                                        to_torch(flows), 5, 1, **kw)
    assert td.shape == jd.shape and ti.shape == ji.shape
    assert_close(td, jd, "dists")
    # the JAX default route is not the lattice: cells agree but at a tie;
    # each of the offsets' components (dt, dh, dw)
    for c in range(3):
        assert_cells_match(ti[..., c], np.asarray(ji)[..., c], jd)
