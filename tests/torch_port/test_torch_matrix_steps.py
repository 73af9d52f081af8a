"""The twin of benchmarks/matrix.py's search-only configs
(stnls_tpu_torch/matrix_steps.py) against the same JAX modules, at a small
size: each config's own ps, F a head, ws, wt, K, heads, itype and anchor,
with T = 8 and 24x32 frames. The JAX search is held to its lattice engine
(impl="lattice"; the TPU-only budgets matrix.py passes are dropped). Dists,
offsets and the video gradient agree to 1e-4 (torch_port_helpers). A
search with more ranked slots than B1 keeps (K = 80 of 243 cells) takes
the volume route on every device and gives JAX's lattice top-K."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import stnls_tpu
from stnls_tpu_torch import matrix_steps
from stnls_tpu_torch.ops.nls_cuda import KMAX
from stnls_tpu_torch.search.non_local_search import NonLocalSearch, \
    search_route

from torch_port_helpers import to_torch, assert_close, assert_grad_close

SIZE = dict(T=8, H=24, W=32)


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


@pytest.mark.parametrize("name", list(matrix_steps.CONFIGS))
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
