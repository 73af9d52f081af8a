"""The twin of benchmarks/matrix.py's configs
(stnls_tpu_torch/matrix_steps.py) against the same JAX modules, at a small
size: each search config's own ps, F a head, ws, wt, K, heads, itype and
anchor, with T = 8 and 24x32 frames; config 6's denoiser at its widths on
T = 3 frames of 24x32, its parameters carried over from matrix.py's flax
init by params_from_jax. The JAX search is held to its lattice engine
(impl="lattice"; the TPU-only budgets matrix.py passes are dropped).
Dists, offsets, outputs and losses agree to atol = rtol = 1e-4, the video's
and the parameters' gradients to 1e-4 * max|ref| (torch_port_helpers). A
search with more ranked slots than B1 keeps (K = 80 of 243 cells) takes
the volume route on every device and gives JAX's lattice top-K."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import stnls_tpu
from stnls_tpu.models.denoiser import NonLocalDenoiser as JDenoiser
from stnls_tpu.utils.config import ConfigDict as JConfigDict
from stnls_tpu_torch import matrix_steps
from stnls_tpu_torch.convert import params_from_jax
from stnls_tpu_torch.ops.nls_cuda import KMAX
from stnls_tpu_torch.search.non_local_search import NonLocalSearch, \
    search_route

from torch_port_helpers import to_torch, assert_close, assert_grad_close

SIZE = dict(T=8, H=24, W=32)
SEARCH_CONFIGS = [name for name, cfg in matrix_steps.CONFIGS.items()
                  if cfg["config"] != 6]
DENOISER = "denoiser540p_train_step"
DENOISER_SIZE = dict(T=3, H=24, W=32)


def _jax_step(cfg):
    """matrix.py's step of the config, on the JAX lattice: (loss or None,
    dists, offsets) as a function of the video and the flows."""
    search = stnls_tpu.search.NonLocalSearch(
        cfg["ws"], cfg["wt"], cfg["ps"], cfg["K"], nheads=cfg["HD"],
        self_action="anchor", itype=cfg["itype"], impl="lattice")
    gather = stnls_tpu.agg.NonLocalGather(ps=cfg["ps"], stride0=1,
                                          itype="int", wt_hint=2 * cfg["wt"])

    def step(v, *flows):
        d, i = search(v, v, *flows)
        if cfg["config"] == 1:
            w = jax.nn.softmax(-10. * d, axis=-1)
            loss = jnp.mean(gather(v, w, i) ** 2)
        else:
            loss = jnp.mean(d ** 2)
        return loss, (d, i)

    return step


@pytest.mark.parametrize("name", SEARCH_CONFIGS)
def test_matrix_step_matches_jax(name):
    cfg = matrix_steps.config(name, **SIZE)
    inputs = matrix_steps.make_inputs(name, device="cpu", **SIZE)
    out = matrix_steps.make_step(name, **SIZE)(*inputs)
    B, HD, T, K = cfg["B"], cfg["HD"], cfg["T"], cfg["K"]
    assert out["dists"].shape == (B, HD, T, cfg["H"], cfg["W"], K)
    assert out["inds"].shape == out["dists"].shape + (3,)
    assert set(out) == ({"dists", "inds", "loss", "g_vid"} if cfg["backward"]
                        else {"dists", "inds"})
    # q = k: the anchored self cell is the query's own patch
    assert not out["dists"][..., 0].any()

    jstep = _jax_step(cfg)
    arrays = [jnp.asarray(x.numpy()) for x in inputs]
    if cfg["backward"]:
        (jloss, (jd, ji)), jg = jax.value_and_grad(jstep, has_aux=True)(
            *arrays)
        assert_close(out["loss"], jloss, "loss")
        assert_grad_close(out["g_vid"], jg, "g_vid")
        assert float(out["g_vid"].abs().max()) > 0
    else:
        _, (jd, ji) = jstep(*arrays)
    assert_close(out["dists"], jd, "dists")
    assert_close(out["inds"], ji, "inds")


def test_matrix_inputs_follow_matrix_py():
    """matrix.py draws the video first, then the flows, from seed 0."""
    vid, ff, bf = matrix_steps.make_inputs("align1080p_fwd", device="cpu",
                                           **SIZE)
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(
        vid.numpy(), rng.standard_normal((1, 8, 4, 24, 32)).astype(np.float32))
    assert 1.4 < float(ff.abs().max()) <= 3.0 + 1e-6
    assert not torch.equal(ff, bf)
    vid1, f1, b1 = matrix_steps.make_inputs("davis64_int", device="cpu",
                                            **SIZE)
    assert torch.equal(f1, b1) and torch.equal(f1, f1.round())


def test_denoiser_step_matches_jax():
    """Config 6: the loss mean((denoiser(noisy) - vid)^2) and its gradient
    to every parameter against jax.grad of matrix.py's loss, from
    matrix.py's flax init (PRNGKey(0)) carried over."""
    cfg = matrix_steps.config(DENOISER, **DENOISER_SIZE)
    inputs = matrix_steps.make_inputs(DENOISER, device="cpu",
                                      **DENOISER_SIZE)
    noisy, vid, ff, bf = (jnp.asarray(x.numpy()) for x in inputs)
    flows = JConfigDict(fflow=ff, bflow=bf)
    jmodel = JDenoiser(
        embed_dim=cfg["embed_dim"], nheads=cfg["nheads"], ws=cfg["ws"],
        wt=cfg["wt"], ps=cfg["ps"], k=cfg["K"], nres=cfg["nres"],
        search_overrides=dict(matrix_steps.DENOISER_SEARCH, impl="lattice"),
        agg_overrides=matrix_steps.DENOISER_AGG)
    params = jmodel.init(jax.random.PRNGKey(0), noisy, flows)

    def loss(p, v):
        out, _ = jmodel.apply(p, v, flows)
        return jnp.mean((out - vid) ** 2), out

    (jloss, jout), jgrads = jax.value_and_grad(loss, has_aux=True)(params,
                                                                   noisy)
    step = matrix_steps.make_step(
        DENOISER, params=params_from_jax(jax.tree.map(np.asarray, params)),
        **DENOISER_SIZE)
    out = step(*inputs)
    assert set(out) == {"out", "loss", "grads"}
    assert out["out"].shape == (1, 3, 3, 24, 32)
    assert_close(out["out"], jout, "output")
    assert_close(out["loss"], jloss, "loss")
    ref = params_from_jax(jax.tree.map(np.asarray, jgrads))
    assert set(out["grads"]) == set(ref) == \
        {n for n, _ in step.model.named_parameters()}
    for name, g in out["grads"].items():
        assert float(g.abs().max()) > 0, name
        assert_grad_close(g, ref[name].numpy(), name)


def test_denoiser_inputs_follow_matrix_py():
    """matrix.py's config 6 draws vid, then the noise of noisy = vid + 0.1
    * N, then fflow and bflow (amplitude 3), from seed 0; without params
    the step's denoiser is seeded by a torch.Generator."""
    noisy, vid, ff, bf = matrix_steps.make_inputs(DENOISER, device="cpu",
                                                  **DENOISER_SIZE)
    rng = np.random.default_rng(0)
    shape = (1, 3, 3, 24, 32)
    v = rng.standard_normal(shape).astype(np.float32)
    n = rng.standard_normal(shape).astype(np.float32)
    np.testing.assert_array_equal(vid.numpy(), v)
    np.testing.assert_array_equal(noisy.numpy(),
                                  np.asarray(jnp.asarray(v) + 0.1
                                             * jnp.asarray(n)))
    np.testing.assert_array_equal(
        ff.numpy(), matrix_steps.smooth_flows(rng, (1, 3, 2, 24, 32),
                                              amp=3.0))
    assert 1.4 < float(bf.abs().max()) <= 3.0 + 1e-6
    a, b = (matrix_steps.make_step(DENOISER, seed=s, **DENOISER_SIZE).model
            for s in (0, 0))
    c = matrix_steps.make_step(DENOISER, seed=1, **DENOISER_SIZE).model
    for (name, pa), pb, pc in zip(a.named_parameters(), b.parameters(),
                                  c.parameters()):
        assert torch.equal(pa, pb), name
        assert not torch.equal(pa, pc), name


def test_many_ranked_slots_take_the_volume_route(rng):
    """K = 80 anchored over 243 cells: 79 ranked slots, more than B1 keeps.
    The route is a function of the config and the shape alone, so a CUDA
    tensor takes it too; the result is JAX's lattice top-K."""
    B, HD, T, F, H, W = 1, 1, 4, 2, 24, 32
    kw = dict(nheads=HD, self_action="anchor", itype="float", stride1=1)
    tsearch = NonLocalSearch(9, 1, 1, 80, **kw)
    assert search_route(tsearch.cfg, (B, HD, T, F, H, W)) == "volume"
    assert search_route(dict(tsearch.cfg, k=KMAX + 1),
                        (B, HD, T, F, H, W)) == "topk"
    assert search_route(dict(tsearch.cfg, k=KMAX + 2),
                        (B, HD, T, F, H, W)) == "volume"

    v0 = rng.standard_normal((B, T, HD * F, H, W)).astype(np.float32)
    v1 = rng.standard_normal((B, T, HD * F, H, W)).astype(np.float32)
    ff = (2 * rng.standard_normal((B, T, 2, H, W))).astype(np.float32)
    bf = (2 * rng.standard_normal((B, T, 2, H, W))).astype(np.float32)
    jsearch = stnls_tpu.search.NonLocalSearch(9, 1, 1, 80, impl="lattice",
                                              **kw)
    gd = rng.standard_normal((B, HD, T, H, W, 80)).astype(np.float32)

    def jloss(a, b, f):
        d, i = jsearch(a, b, f, jnp.asarray(bf))
        return jnp.sum(d * gd), (d, i)

    (_, (jd, ji)), jg = jax.value_and_grad(jloss, (0, 1, 2), has_aux=True)(
        jnp.asarray(v0), jnp.asarray(v1), jnp.asarray(ff))
    leaves = [to_torch(x, True) for x in (v0, v1, ff)]
    td, ti = tsearch(*leaves, to_torch(bf))
    tg = torch.autograd.grad((td * torch.from_numpy(gd)).sum(), leaves)
    assert td.shape == jd.shape == (B, HD, T, H, W, 80)
    assert_close(td, jd, "dists")
    assert_close(ti, ji, "inds")
    for a, b, what in zip(tg, jg, ("g_vid0", "g_vid1", "g_fflow")):
        assert_grad_close(a, b, what)
