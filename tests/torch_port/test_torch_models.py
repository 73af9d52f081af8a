"""Port parity of the model layer (stnls_tpu_torch.models): ResBlock,
ResBlockList, ChannelAttention and NonLocalDenoiser against the JAX
package's flax modules, with flax parameters carried over by
params_from_jax, and the converter's path mapping.

Inputs come from numpy seed 0. The JAX search runs on its exact lattice
engine (search_overrides={"impl": "lattice"}). Outputs agree within
atol = rtol = 1e-4; the video's and every parameter's gradients within
1e-4 * max|ref| (torch_port_helpers.assert_close / assert_grad_close).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from stnls_tpu.models import ResBlock as JResBlock, \
    ResBlockList as JResBlockList, ChannelAttention as JChannelAttention, \
    NonLocalDenoiser as JDenoiser
from stnls_tpu.utils.config import ConfigDict as JConfigDict
from stnls_tpu_torch.convert import params_from_jax
from stnls_tpu_torch.models import ResBlock, ResBlockList, \
    ChannelAttention, NonLocalDenoiser
from stnls_tpu_torch.utils.config import ConfigDict

from torch_port_helpers import to_torch, assert_close, assert_grad_close

B, T, C, H, W = 1, 3, 3, 24, 24
DENOISER = dict(embed_dim=4, nheads=2, ws=5, wt=1, ps=3, k=6, nres=2)


def _numpy_tree(params):
    return jax.tree.map(np.asarray, params)


def _check_module(jmodel, tmodel, x, loss_of):
    """Output, input gradient and every parameter gradient of `tmodel`
    (parameters from jmodel's flax init) against jmodel's."""
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x))

    def jloss(p, v):
        out = jmodel.apply(p, v)
        return loss_of(out), out

    (_, jout), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    tmodel.load_state_dict(params_from_jax(_numpy_tree(params)))
    tx = to_torch(x, True)
    tout = tmodel(tx)
    assert_close(tout, jout, "output")
    names, tparams = zip(*tmodel.named_parameters())
    tg = torch.autograd.grad(loss_of(tout), (tx,) + tparams)
    assert_grad_close(tg[0], jgx, "input gradient")
    jgrads = params_from_jax(_numpy_tree(jgp))
    assert set(jgrads) == set(names)
    for name, g in zip(names, tg[1:]):
        assert float(g.abs().max()) > 0, name
        assert_grad_close(g, jgrads[name].numpy(), name)


@pytest.mark.parametrize("block", ["ResBlock", "ResBlockList",
                                   "ChannelAttention"])
def test_block_matches_flax(rng, block):
    dim = 8
    x = rng.standard_normal((2, dim, 12, 10)).astype(np.float32)
    target = rng.standard_normal(x.shape).astype(np.float32)
    jmodel, tmodel = {
        "ResBlock": (JResBlock(dim), ResBlock(dim)),
        "ResBlockList": (JResBlockList(2, dim), ResBlockList(2, dim)),
        "ChannelAttention": (JChannelAttention(dim), ChannelAttention(dim)),
    }[block]

    def loss_of(out):
        tgt = torch.from_numpy(target) if isinstance(out, torch.Tensor) \
            else jnp.asarray(target)
        return ((out - tgt) ** 2).mean()

    _check_module(jmodel, tmodel, x, loss_of)


def _denoiser_inputs(rng):
    vid = rng.standard_normal((B, T, C, H, W)).astype(np.float32)
    clean = rng.standard_normal((B, T, C, H, W)).astype(np.float32)
    ff = (2 * rng.standard_normal((B, T, 2, H, W))).astype(np.float32)
    bf = (2 * rng.standard_normal((B, T, 2, H, W))).astype(np.float32)
    return vid, clean, ff, bf


def test_denoiser_matches_flax(rng):
    """Output, video gradient and every parameter's gradient of
    mean((out - clean)^2) at 24^2, ps 3, k 6, two heads of 4, two res
    blocks."""
    vid, clean, ff, bf = _denoiser_inputs(rng)
    jmodel = JDenoiser(**DENOISER, search_overrides={"impl": "lattice"})
    jflows = JConfigDict(fflow=jnp.asarray(ff), bflow=jnp.asarray(bf))
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(vid), jflows)

    def jloss(p, v):
        out, _ = jmodel.apply(p, v, jflows)
        return jnp.mean((out - clean) ** 2), out

    (_, jout), (jgp, jgv) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(vid))

    tmodel = NonLocalDenoiser(in_dim=C, **DENOISER)
    tmodel.load_state_dict(params_from_jax(_numpy_tree(params)))
    tv = to_torch(vid, True)
    tout, state = tmodel(tv, ConfigDict(fflow=to_torch(ff),
                                        bflow=to_torch(bf)))
    assert state is None
    assert tout.shape == (B, T, C, H, W)
    assert_close(tout, jout, "denoiser output")
    names, tparams = zip(*tmodel.named_parameters())
    tg = torch.autograd.grad((tout - torch.from_numpy(clean)).pow(2).mean(),
                             (tv,) + tparams)
    assert_grad_close(tg[0], jgv, "g_vid")
    jgrads = params_from_jax(_numpy_tree(jgp))
    assert set(jgrads) == set(names)
    for name, g in zip(names, tg[1:]):
        assert float(g.abs().max()) > 0, name
        assert_grad_close(g, jgrads[name].numpy(), name)


def test_denoiser_state_update_matches_flax(rng):
    """use_state_update through search_overrides: the next state carries
    this call's offsets, in the JAX layout [T,nH,nW,B,HD,K,3]."""
    vid, _, ff, bf = _denoiser_inputs(rng)
    over = {"use_state_update": True}
    jmodel = JDenoiser(**DENOISER,
                       search_overrides=dict(over, impl="lattice"))
    jflows = JConfigDict(fflow=jnp.asarray(ff), bflow=jnp.asarray(bf))
    params = jmodel.init(jax.random.PRNGKey(1), jnp.asarray(vid), jflows,
                         [None, None])
    jout, jstate = jmodel.apply(params, jnp.asarray(vid), jflows,
                                [None, None])
    tmodel = NonLocalDenoiser(in_dim=C, **DENOISER, search_overrides=over)
    tmodel.load_state_dict(params_from_jax(_numpy_tree(params)))
    tout, tstate = tmodel(to_torch(vid), ConfigDict(fflow=to_torch(ff),
                                                    bflow=to_torch(bf)),
                          [None, None])
    assert_close(tout, jout, "output")
    assert tstate[1] is None and jstate[1] is None
    assert tuple(tstate[0].shape) == (T, H, W, B, 2, DENOISER["k"], 3)
    assert_close(tstate[0], jstate[0], "state offsets")


def test_params_from_jax_maps_paths():
    """Every path of the denoiser's flax tree lands on a torch parameter,
    by its own layout; unknown paths and kernels of the wrong rank for
    their path raise."""
    rng = np.random.default_rng(0)
    jmodel = JDenoiser(**DENOISER, search_overrides={"impl": "lattice"})
    zeros = jnp.zeros((B, T, C, 16, 16))
    flows = JConfigDict(fflow=jnp.zeros((B, T, 2, 16, 16)),
                        bflow=jnp.zeros((B, T, 2, 16, 16)))
    params = _numpy_tree(jmodel.init(jax.random.PRNGKey(0), zeros, flows))
    sd = params_from_jax(params)
    tmodel = NonLocalDenoiser(in_dim=C, **DENOISER)
    assert set(sd) == set(tmodel.state_dict())
    for name, val in tmodel.state_dict().items():
        assert tuple(sd[name].shape) == tuple(val.shape), name
    p = params["params"]
    np.testing.assert_array_equal(sd["chnl.dense0.weight"].numpy(),
                                  p["chnl"]["Dense_0"]["kernel"].T)
    np.testing.assert_array_equal(sd["embed.weight"][:, :, 0, 2].numpy(),
                                  p["embed"]["kernel"][0, 2].T)
    np.testing.assert_array_equal(sd["attn.qkv.to_v.bias"].numpy(),
                                  p["attn"]["qkv"]["to_v"]["bias"])
    k = rng.standard_normal((3, 3, 2, 2)).astype(np.float32)
    with pytest.raises(KeyError):
        params_from_jax({"decoder": {"conv0": {"kernel": k}}})
    with pytest.raises(KeyError):
        params_from_jax({"chnl": {"Dense_0": {"kernel": k}}})
    with pytest.raises(KeyError):
        params_from_jax({"agg": {"proj": {"Conv_0": {"kernel": k}}}})
