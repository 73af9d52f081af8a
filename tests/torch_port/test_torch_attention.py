"""Port parity of the main path as a whole: NonLocalAttention with flax
parameters carried over by params_from_jax, and the bench attention step
(search_flow -> NonLocalSearch -> softmax -> NonLocalGather -> K-mixing
projection), forward and grads."""

import numpy as np
import jax
import jax.numpy as jnp
import torch

import stnls_tpu
from stnls_tpu.nn import NonLocalAttention as JAttention
from stnls_tpu.utils.config import ConfigDict as JConfigDict
from stnls_tpu_torch.attn_step import AttnStep
from stnls_tpu_torch.convert import params_from_jax
from stnls_tpu_torch.nn import NonLocalAttention as TAttention
from stnls_tpu_torch.utils.config import ConfigDict

from torch_port_helpers import to_torch, assert_close, assert_grad_close

B, T, H, W = 1, 3, 24, 24


def _cfgs():
    attn_cfg = {"nheads": 2, "embed_dim": 4, "use_attn_projection": True,
                "use_attn_flow": True, "use_norm_layer": True}
    search_cfg = {"search_name": "nls", "ws": 5, "wt": 1, "ps": 3, "k": 6,
                  "nheads": 2, "stride0": 1, "stride1": 0.5,
                  "self_action": "anchor", "itype": "float",
                  "dist_type": "l2", "impl": "lattice"}
    normz_cfg = {"normz_name": "softmax", "normz_scale": 10,
                 "dist_type": "l2"}
    agg_cfg = {"agg_name": "gather", "ps": 3, "stride0": 1,
               "itype": "float"}
    return attn_cfg, search_cfg, normz_cfg, agg_cfg


def test_non_local_attention_matches_flax(rng):
    cfgs = _cfgs()
    vid = rng.standard_normal((B, T, 8, H, W)).astype(np.float32)
    ff = (2 * rng.standard_normal((B, T, 2, H, W))).astype(np.float32)
    bf = (2 * rng.standard_normal((B, T, 2, H, W))).astype(np.float32)
    jmodel = JAttention(*cfgs)
    jflows = JConfigDict(fflow=jnp.asarray(ff), bflow=jnp.asarray(bf))
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(vid), jflows)
    params_np = jax.tree.map(np.asarray, params)

    def jloss(p, v, f):
        out, _ = jmodel.apply(p, v, JConfigDict(fflow=f,
                                                bflow=jnp.asarray(bf)))
        return jnp.mean(out ** 2), out

    (_, jout), (jgp, jgv, jgf) = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(params, jnp.asarray(vid),
                                                jnp.asarray(ff))

    tmodel = TAttention(*cfgs)
    tmodel.load_state_dict(params_from_jax(params_np))
    tv, tf = to_torch(vid, True), to_torch(ff, True)
    tout, _ = tmodel(tv, ConfigDict(fflow=tf, bflow=to_torch(bf)))
    assert_close(tout, jout, "NonLocalAttention output")
    gv, gf = torch.autograd.grad(tout.pow(2).mean(), (tv, tf))
    assert_grad_close(gv, jgv, "g_vid")
    assert_grad_close(gf, jgf, "g_fflow")

    # recurrent state: the next state carries this call's inds
    scfg = dict(cfgs[1], use_state_update=True)
    jstate = JAttention(cfgs[0], scfg, *cfgs[2:]).apply(
        params, jnp.asarray(vid), jflows, [None, None])[1]
    tstate_model = TAttention(cfgs[0], scfg, *cfgs[2:])
    tstate_model.load_state_dict(params_from_jax(params_np))
    tstate = tstate_model(
        to_torch(vid), ConfigDict(fflow=to_torch(ff), bflow=to_torch(bf)),
        [None, None])[1]
    assert tstate[1] is None and jstate[1] is None
    assert_close(tstate[0], jstate[0], "state inds")

    tmodel.zero_grad()
    tout, _ = tmodel(tv, ConfigDict(fflow=tf, bflow=to_torch(bf)))
    tout.pow(2).mean().backward()
    jgrads = params_from_jax(jax.tree.map(np.asarray, jgp))
    for name, p in tmodel.named_parameters():
        assert_grad_close(p.grad, jgrads[name].numpy(), name)


def test_bench_attention_step(rng):
    F, K, wt = 8, 6, 1
    vid = rng.standard_normal((B, T, F, H, W)).astype(np.float32)
    # small projections keep softmax(-10 d) spread over the K neighbours,
    # so the step depends on the flows
    proj_w = (0.02 * rng.standard_normal((F, F))).astype(np.float32)
    stack_w = (rng.standard_normal((K, F, F)) / 8.).astype(np.float32)
    ff = (2 * rng.standard_normal((B, T, 2, H, W))).astype(np.float32)
    bf = (2 * rng.standard_normal((B, T, 2, H, W))).astype(np.float32)
    search = stnls_tpu.search.NonLocalSearch(
        5, wt, 3, K, nheads=2, stride0=1, stride1=0.5, self_action="anchor",
        itype="float", impl="lattice")
    gather = stnls_tpu.agg.NonLocalGather(ps=3, stride0=1)

    def jattn(v_in, fflow, bflow):
        q = jnp.einsum("btchw,cd->btdhw", v_in, proj_w)
        flows = stnls_tpu.nn.search_flow(fflow, bflow, wt, 1)
        dists, srch_flows = search(q, q, flows)
        weights = jax.nn.softmax(-10. * dists, axis=-1)
        stack = gather(q, weights, srch_flows)
        Bs, HDs, Ks, Ts, Fs, Hs, Ws = stack.shape
        stack = jnp.transpose(stack, (0, 3, 2, 1, 4, 5, 6)) \
            .reshape(Bs, Ts, Ks, HDs * Fs, Hs, Ws)
        return jnp.einsum("btkchw,kcd->btdhw", stack, stack_w)

    jout = jattn(*map(jnp.asarray, (vid, ff, bf)))
    jgv, jgf = jax.grad(lambda v, f: jnp.mean(
        jattn(v, f, jnp.asarray(bf)) ** 2), argnums=(0, 1))(
        jnp.asarray(vid), jnp.asarray(ff))

    step = AttnStep(ws=5, wt=wt, ps=3, k=K, nheads=2, stride1=0.5)
    tv, tf = to_torch(vid, True), to_torch(ff, True)
    tout = step(tv, tf, to_torch(bf), to_torch(proj_w), to_torch(stack_w))
    assert_close(tout, jout, "step output")
    gv, gf = torch.autograd.grad(tout.pow(2).mean(), (tv, tf))
    assert np.abs(np.asarray(jgf)).max() > 0
    assert_grad_close(gv, jgv, "g_vid")
    assert_grad_close(gf, jgf, "g_fflow")


def test_sgd_steps_match_flax(rng):
    """A trainer's few steps: 3 SGD steps of NonLocalAttention towards a
    fixed target, in both packages from the same parameters; the
    parameters agree to 1e-4 * max|p| after every step."""
    cfgs = _cfgs()
    lr, steps = 0.5, 3
    vid = rng.standard_normal((B, T, 8, H, W)).astype(np.float32)
    target = rng.standard_normal((B, T, 8, H, W)).astype(np.float32)
    ff = (2 * rng.standard_normal((B, T, 2, H, W))).astype(np.float32)
    bf = (2 * rng.standard_normal((B, T, 2, H, W))).astype(np.float32)
    jmodel = JAttention(*cfgs)
    jflows = JConfigDict(fflow=jnp.asarray(ff), bflow=jnp.asarray(bf))
    params = jmodel.init(jax.random.PRNGKey(1), jnp.asarray(vid), jflows)
    tmodel = TAttention(*cfgs)
    tmodel.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    start = {n: p.detach().clone() for n, p in tmodel.named_parameters()}

    jgrad = jax.jit(jax.grad(lambda p: jnp.mean(
        (jmodel.apply(p, jnp.asarray(vid), jflows)[0] - target) ** 2)))
    tflows = ConfigDict(fflow=to_torch(ff), bflow=to_torch(bf))
    for step in range(steps):
        params = jax.tree.map(lambda p, g: p - lr * g, params,
                              jgrad(params))
        tmodel.zero_grad()
        out, _ = tmodel(to_torch(vid), tflows)
        (out - torch.from_numpy(target)).pow(2).mean().backward()
        with torch.no_grad():
            for p in tmodel.parameters():
                p -= lr * p.grad
        ref = params_from_jax(jax.tree.map(np.asarray, params))
        for name, p in tmodel.named_parameters():
            assert_grad_close(p, ref[name].numpy(), f"step {step} {name}")
    moved = max(float((p - start[n]).abs().max() / start[n].abs().max())
                for n, p in tmodel.named_parameters())
    assert moved > 1e-2
