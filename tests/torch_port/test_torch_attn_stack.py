"""Port parity of the stack attention and the stack aggregator:
NonLocalAttentionStack (stnls_tpu_torch.nn), StackConv and its projection
menu (stnls_tpu_torch.agg.{stack_conv,proj_menu}), NonLocalAttention with
agg_name="stack_conv", and attn_timer on both attention modules, against
the JAX package's flax modules with parameters carried over by
params_from_jax.

Inputs come from numpy seed 0. The JAX search runs on its exact lattice
engine (impl="lattice"). Outputs agree within atol = rtol = 1e-4; the
video's, the weights' and every parameter's gradients within 1e-4 *
max|ref| (torch_port_helpers.assert_close / assert_grad_close).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from stnls_tpu.agg import stack_conv as jstack_conv, proj_menu as jproj_menu
from stnls_tpu.nn import NonLocalAttention as JAttention, \
    NonLocalAttentionStack as JStack
from stnls_tpu.utils.config import ConfigDict as JConfigDict
from stnls_tpu_torch.agg import stack_conv, proj_menu
from stnls_tpu_torch.convert import params_from_jax
from stnls_tpu_torch.nn import NonLocalAttention, NonLocalAttentionStack
from stnls_tpu_torch.utils.config import ConfigDict

from torch_port_helpers import to_torch, assert_close, assert_grad_close

B, T, H, W = 1, 3, 16, 16
STAGES = {"qkv", "search", "normz", "agg", "proj"}


def _cfgs(agg_name="gather", **attn):
    attn_cfg = {"nheads": 2, "embed_dim": 4, "use_attn_projection": True,
                "use_attn_flow": True, **attn}
    search_cfg = {"search_name": "nls", "ws": 5, "wt": 1, "ps": 3, "k": 4,
                  "nheads": 2, "stride0": 1, "self_action": "anchor",
                  "itype": "float", "dist_type": "l2", "impl": "lattice"}
    normz_cfg = {"normz_name": "softmax", "normz_scale": 10,
                 "dist_type": "l2"}
    agg_cfg = {"agg_name": agg_name, "ps": 3, "stride0": 1,
               "itype": "float"}
    if agg_name == "gather_add":
        agg_cfg = {"agg_name": "gather_add", "ps": 3, "strideIn": 1,
                   "strideOut": 1, "itype": "float"}
    elif agg_name == "stack_conv":
        agg_cfg.update(embed_dim=4, nheads=2, inner_mult=1, k_agg=2)
    return attn_cfg, search_cfg, normz_cfg, agg_cfg


def _inputs(rng, C=8):
    vid = rng.standard_normal((B, T, C, H, W)).astype(np.float32)
    ff = (2 * rng.standard_normal((B, T, 2, H, W))).astype(np.float32)
    bf = (2 * rng.standard_normal((B, T, 2, H, W))).astype(np.float32)
    return vid, ff, bf


def _check_attention(rng, jcls, tcls, cfgs):
    """Output, video gradient and every parameter's gradient of
    mean(out^2) of the torch module against the flax one's."""
    vid, ff, bf = _inputs(rng)
    jmodel = jcls(*cfgs)
    jflows = JConfigDict(fflow=jnp.asarray(ff), bflow=jnp.asarray(bf))
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(vid), jflows)

    def jloss(p, v):
        out, _ = jmodel.apply(p, v, jflows)
        return jnp.mean(out ** 2), out

    (_, jout), (jgp, jgv) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(vid))
    tmodel = tcls(*cfgs)
    tmodel.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    tv = to_torch(vid, True)
    tout, _ = tmodel(tv, ConfigDict(fflow=to_torch(ff), bflow=to_torch(bf)))
    assert tout.shape == (B, T, 8, H, W)
    assert_close(tout, jout, "output")
    names, tparams = zip(*tmodel.named_parameters())
    # with share_kv the value projection is unused: no gradient, and 0 in
    # flax
    tg = torch.autograd.grad(tout.pow(2).mean(), (tv,) + tparams,
                             allow_unused=True)
    assert float(tg[0].abs().max()) > 0
    assert_grad_close(tg[0], jgv, "g_vid")
    jgrads = params_from_jax(jax.tree.map(np.asarray, jgp))
    assert set(jgrads) == set(names)
    for name, p, g in zip(names, tparams, tg[1:]):
        g = torch.zeros_like(p) if g is None else g
        assert_grad_close(g, jgrads[name].numpy(), name)
    return tmodel


@pytest.mark.parametrize("share_kv", [False, True])
@pytest.mark.parametrize("agg_name", ["gather", "gather_add"])
def test_stack_matches_flax(rng, agg_name, share_kv):
    """The gather stack [B,HD,K,T,F,H,W] mixed over its (K, HD, F)
    channels, and gather_add's video (the 6-d branch) over (HD, F)."""
    cfgs = _cfgs(agg_name, share_kv=share_kv)
    model = _check_attention(rng, JStack, NonLocalAttentionStack, cfgs)
    slots = 4 if agg_name == "gather" else 1
    assert model.stack_proj.in_channels == slots * 8


@pytest.mark.parametrize("search_name", ["refine", "rand_inds"])
def test_stack_unported_searches_raise(search_name):
    """The refine and rand_inds branches build and run now (the refine
    state path against flax is in test_torch_search_flavors.py): no
    NotImplementedError; the refine branch takes ref_itype."""
    attn_cfg, search_cfg, normz_cfg, agg_cfg = _cfgs(ref_itype="int")
    search_cfg = dict(search_cfg, search_name=search_name)
    model = NonLocalAttentionStack(attn_cfg, search_cfg, normz_cfg, agg_cfg)
    if search_name == "refine":
        assert model.search.itype == "int"
    vid, ff, bf = _inputs(np.random.default_rng(0))
    flows = ConfigDict(fflow=to_torch(ff), bflow=to_torch(bf))
    state = None
    if search_name == "refine":
        # the previous call's offsets in the state layout
        nls = NonLocalAttentionStack(attn_cfg, dict(
            _cfgs()[1], use_state_update=True), normz_cfg, agg_cfg)
        with torch.no_grad():
            _, state = nls(to_torch(vid), flows, state=[torch.zeros(()),
                                                        None])
    with torch.no_grad():
        out, _ = model(to_torch(vid), flows, state=state)
    assert out.shape == (B, T, 8, H, W) and bool(torch.isfinite(out).all())


def test_state_layout_round_trip(rng):
    """_inds_rs1 (the refine branch's state -> offsets) is the inverse of
    _inds_rs0 (offsets -> state) and equal to JAX's."""
    from stnls_tpu.nn.non_local_attn import _inds_rs1 as j_rs1
    from stnls_tpu_torch.nn.non_local_attn import _inds_rs0, _inds_rs1
    inds = rng.integers(-3, 4, (1, 2, 3 * 4 * 5, 6, 3)).astype(np.float32)
    state = _inds_rs0(torch.from_numpy(inds), 4, 5)
    assert state.shape == (3, 4, 5, 1, 2, 6, 3)
    back = _inds_rs1(state)
    np.testing.assert_array_equal(back.numpy(), inds)
    np.testing.assert_array_equal(back.numpy(),
                                  np.asarray(j_rs1(jnp.asarray(state))))


def test_attention_with_stack_conv_matches_flax(rng):
    """NonLocalAttention whose aggregator is StackConv (a torch
    submodule `agg`, its Conv3d carried over from agg/proj/Conv_0)."""
    model = _check_attention(rng, JAttention, NonLocalAttention,
                             _cfgs("stack_conv"))
    assert isinstance(model.agg, stack_conv.StackConv)
    assert tuple(model.agg.proj.conv.weight.shape) == (8, 4, 2, 3, 3)


def _stack_inputs(rng, itype, HD=2, F=4, K=3):
    vid = rng.standard_normal((B, 2, HD * F, 8, 8)).astype(np.float32)
    weights = rng.random((B, HD, 2, 8, 8, K)).astype(np.float32)
    shape = (B, HD, 2, 8, 8, K)
    if itype == "int":
        hw = [rng.integers(-1, 2, shape) for _ in range(2)]
    else:
        hw = [rng.uniform(-1.5, 1.5, shape) for _ in range(2)]
    flows = np.stack([np.zeros(shape)] + hw, -1).astype(np.float32)
    return vid, weights, flows


@pytest.mark.parametrize("itype", ["int", "float"])
@pytest.mark.parametrize("version", ["v1", "v2"])
def test_stack_conv_matches_flax(rng, version, itype):
    """The cases of tests/agg/test_stack_conv.py: StackConv's output and
    its gradients to the video and the weights (and the float offsets)."""
    HD, F, K = 2, 4, 3
    cfg = {"ps": 3, "stride0": 1, "itype": itype, "embed_dim": F,
           "inner_mult": 1, "k_agg": K, "nheads": HD,
           "nlstack_proj_version": version,
           "attn_proj_ksize": "k_ps_ps", "attn_proj_stride": "k_1_1",
           "attn_proj_ngroups": "nheads"}
    vid, weights, flows = _stack_inputs(rng, itype, HD, F, K)
    jmod = jstack_conv.init(cfg)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(vid),
                       jnp.asarray(weights), jnp.asarray(flows))
    argnums = (0, 1, 2, 3) if itype == "float" else (0, 1, 2)

    def jloss(p, v, w, f):
        out = jmod.apply(p, v, w, f)
        return jnp.mean(out ** 2), out

    (_, jout), jgrads = jax.value_and_grad(
        jloss, argnums=argnums, has_aux=True)(
        params, *map(jnp.asarray, (vid, weights, flows)))
    tmod = stack_conv.init(cfg)
    assert isinstance(tmod, stack_conv.StackConv)
    sd = params_from_jax({"agg": jax.tree.map(np.asarray, params)["params"]})
    tmod.load_state_dict({k[len("agg."):]: v for k, v in sd.items()})
    leaves = [to_torch(x, True) for x in (vid, weights, flows)]
    tout = tmod(*leaves)
    assert tout.shape == (B, 2, HD * F, 8, 8)
    assert_close(tout, jout, "output")
    tg = torch.autograd.grad(tout.pow(2).mean(),
                             leaves[:len(argnums) - 1])
    for g, jg, what in zip(tg, jgrads[1:], ("g_vid", "g_weights",
                                            "g_flows")):
        assert float(g.abs().max()) > 0, what
        assert_grad_close(g, jg, what)


def test_proj_menu_v1_and_errors():
    HD, F, K, ps = 2, 4, 3, 3
    cfg = {"ps": ps, "embed_dim": F, "inner_mult": 1, "k_agg": K,
           "nheads": HD, "nlstack_proj_version": "v1"}
    proj = proj_menu.init(cfg)
    stack = torch.ones((2, HD * F, K, 8, 8))
    assert proj(stack).shape == (2, HD * F, 1, 8, 8)
    conv = proj.conv
    assert (conv.kernel_size, conv.stride, conv.padding, conv.groups) == (
        (K, ps, ps), (K, 1, 1), (0, 1, 1), HD)
    # the v2 token parser: k -> k_agg, ps -> ps, ps//2 -> ps // 2
    v2 = proj_menu.init(dict(cfg, nlstack_proj_version="v2",
                             attn_proj_ksize="1_ps_ps",
                             attn_proj_stride="1_1_1",
                             attn_proj_ngroups="1"))
    assert (v2.conv.kernel_size, v2.conv.stride, v2.conv.groups) == (
        (1, ps, ps), (1, 1, 1), 1)
    assert v2(stack).shape == (2, HD * F, 1, 8, 8)
    with pytest.raises(ValueError):
        proj_menu.get_defaults("v3")
    with pytest.raises(ValueError):
        jproj_menu.get_defaults("v3")
    # flax builds the v1 conv lazily from the stack; torch needs its width
    with pytest.raises(ValueError, match="width"):
        proj_menu.init({"nlstack_proj_version": "v1"})


@pytest.mark.parametrize("module", ["NonLocalAttention",
                                    "NonLocalAttentionStack"])
def test_attn_timer_times_five_stages(rng, module):
    """attn_timer=True: the wall time of each of the five stages in
    `_times`, under the stages' bare names; off, `_times` is empty and the
    stages run under the spans stnls.attn.<stage>."""
    cls = {"NonLocalAttention": NonLocalAttention,
           "NonLocalAttentionStack": NonLocalAttentionStack}[module]
    vid, ff, bf = _inputs(rng)
    flows = ConfigDict(fflow=to_torch(ff), bflow=to_torch(bf))
    model = cls(*_cfgs(attn_timer=True))
    out, _ = model(to_torch(vid), flows)
    assert set(model._times) == STAGES
    assert all(t >= 0 for t in model._times.values())
    quiet = cls(*_cfgs())
    with torch.profiler.profile() as prof:
        quiet(to_torch(vid), flows)
    assert quiet._times == {}
    assert {f"stnls.attn.{s}" for s in STAGES} <= \
        {evt.key for evt in prof.key_averages()}
