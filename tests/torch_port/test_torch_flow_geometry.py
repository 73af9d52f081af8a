"""Port parity: geometry helpers, search_flow (forward and grads), the
flax parameter converter, and the package's independence from JAX."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stnls_tpu.ops import geometry as jgeo
from stnls_tpu.nn import search_flow as j_search_flow
from stnls_tpu.nn.utils import rescale_flows as j_rescale_flows
from stnls_tpu.utils.config import ConfigDict as JConfigDict
from stnls_tpu_torch.ops import geometry as tgeo
from stnls_tpu_torch.nn import search_flow as t_search_flow
from stnls_tpu_torch.nn.utils import rescale_flows as t_rescale_flows
from stnls_tpu_torch.utils.config import ConfigDict
from stnls_tpu_torch.convert import params_from_jax

from torch_port_helpers import to_torch, assert_close, assert_grad_close


def test_reflect_and_window_tables(rng):
    vals = (rng.standard_normal(200) * 20).astype(np.float32)
    for lim in (7, 24):
        assert_close(tgeo.reflect_bounds(to_torch(vals), lim),
                     jgeo.reflect_bounds(jnp.asarray(vals), lim))
        ints = np.arange(-lim + 1, 2 * lim - 2)
        assert (tgeo.reflect_bounds(torch.from_numpy(ints), lim).numpy()
                == np.asarray(jgeo.reflect_bounds(jnp.asarray(ints), lim))).all()
    for T, wt in ((3, 1), (5, 2), (4, 3), (1, 2)):
        assert (tgeo.time_window_frames(T, wt)
                == np.asarray(jgeo.time_window_frames(T, wt))).all()
    assert tgeo.num_queries(24, 17, 2) == jgeo.num_queries(24, 17, 2)


def test_search_offsets_and_bilinear(rng):
    H, W = 24, 20
    hi = rng.uniform(-2, H + 1, 300).astype(np.float32)
    wi = rng.uniform(-2, W + 1, 300).astype(np.float32)
    for stride1, ws, full_ws in ((0.5, 5, True), (1.0, 5, True),
                                 (0.75, 7, True), (1.0, 3, False)):
        got = tgeo.search_offsets(to_torch(hi), to_torch(wi), stride1, ws,
                                  H, W, full_ws, False)
        ref = jgeo.search_offsets(jnp.asarray(hi), jnp.asarray(wi), stride1,
                                  ws, H, W, full_ws, False)
        for g, r in zip(got, ref):
            assert_close(g, r)
    frame = rng.standard_normal((2, H, W)).astype(np.float32)
    assert_close(tgeo.bilinear_gather(to_torch(frame), to_torch(hi[:, None]),
                                      to_torch(wi[None, :]), H, W),
                 jgeo.bilinear_gather(jnp.asarray(frame),
                                      jnp.asarray(hi[:, None]),
                                      jnp.asarray(wi[None, :]), H, W))


def test_search_flow_forward_and_grads(rng):
    B, T, H, W = 1, 4, 16, 16
    ff = (2 * rng.standard_normal((B, T, 2, H, W))).astype(np.float32)
    bf = (2 * rng.standard_normal((B, T, 2, H, W))).astype(np.float32)
    for wt, stride0 in ((1, 1), (2, 2)):
        ref = j_search_flow(jnp.asarray(ff), jnp.asarray(bf), wt, stride0)
        tf, tb = to_torch(ff, True), to_torch(bf, True)
        got = t_search_flow(tf, tb, wt, stride0)
        assert got.shape == ref.shape
        assert_close(got, ref, "search_flow")
        g = rng.standard_normal(ref.shape).astype(np.float32)
        jg = jax.grad(lambda a, b: jnp.sum(
            j_search_flow(a, b, wt, stride0) * g), argnums=(0, 1))(
                jnp.asarray(ff), jnp.asarray(bf))
        tg = torch.autograd.grad((got * torch.from_numpy(g)).sum(), (tf, tb))
        for a, b, name in zip(tg, jg, ("g_fflow", "g_bflow")):
            assert_grad_close(a, b, name)


# The walk's edges, each (B, T, H, W, wt, stride0, noise amplitude, drift):
# a window as wide as the clip (W_t = T, shifted at both ends), wt 1-3 at
# T 10, query strides that do not divide odd frame sizes. With a drift
# (fflow's, bflow's), the flows are that constant motion plus the noise:
# the walks cross the frame's edges (reflected corners), and some forward
# walk samples at floor(h) = 2H - 2, whose lower corner row 2H - 1
# reflects to -1 and is clamped to 0. JAX's walk clips its corner rows
# where a position leaves that single reflection ([-(H-1), 2H-2]), which
# the port clamps axis by axis: the walks here stay inside it.
SEARCH_FLOW_EDGES = {
    "window_is_clip": (1, 4, 12, 10, 2, 1, 1.5, None),
    "window_wider_than_clip": (1, 3, 11, 9, 3, 1, 1.5, None),
    "wt1_T10": (1, 10, 10, 12, 1, 1, 1., None),
    "wt2_T10": (1, 10, 11, 9, 2, 1, 1., None),
    "wt3_T10_B2": (2, 10, 12, 13, 3, 1, 1., None),
    "stride2_odd": (1, 5, 13, 11, 2, 2, 1.5, None),
    "stride3_odd": (1, 6, 11, 14, 2, 3, 1.5, None),
    "reflect_and_clamp": (1, 10, 9, 11, 3, 1, 0.02, (1.64, 1.3)),
    "reflect_and_clamp_stride2": (1, 10, 9, 11, 3, 2, 0.02, (1.64, 1.3)),
}


@pytest.mark.parametrize("case", SEARCH_FLOW_EDGES)
def test_search_flow_edges_forward_and_grads(rng, case):
    """The plain walk (F1's and F2's yardstick on the card) against JAX at
    the walk's edges: the offsets, and the gradients of both flows."""
    B, T, H, W, wt, stride0, amp, drift = SEARCH_FLOW_EDGES[case]
    ff = (amp * rng.standard_normal((B, T, 2, H, W))).astype(np.float32)
    bf = (amp * rng.standard_normal((B, T, 2, H, W))).astype(np.float32)
    if drift is not None:
        ff, bf = ff + np.float32(drift[0]), bf - np.float32(drift[1])
    ref = j_search_flow(jnp.asarray(ff), jnp.asarray(bf), wt, stride0)
    tf, tb = to_torch(ff, True), to_torch(bf, True)
    got = t_search_flow(tf, tb, wt, stride0)
    assert got.shape == ref.shape == (B, T, min(2 * wt + 1, T) - 1, 2) \
        + tgeo.num_queries(H, W, stride0)
    assert_close(got, ref, "search_flow")
    if drift is not None:
        ref_h = torch.arange(got.shape[-2])[:, None] * stride0
        pos = got.detach()[:, :, :, 1] + ref_h
        # the first frame's forward walk samples at each slot but the last
        assert bool((pos[:, 0, :-1].floor() == 2 * H - 2).any())
        assert bool((pos < 0).any()) and bool((pos > H - 1).any())
    g = rng.standard_normal(ref.shape).astype(np.float32)
    jg = jax.grad(lambda a, b: jnp.sum(
        j_search_flow(a, b, wt, stride0) * g), argnums=(0, 1))(
            jnp.asarray(ff), jnp.asarray(bf))
    tg = torch.autograd.grad((got * torch.from_numpy(g)).sum(), (tf, tb))
    for a, b, name in zip(tg, jg, ("g_fflow", "g_bflow")):
        assert float(a.abs().max()) > 0, name
        assert_grad_close(a, b, name)


def test_rescale_flows(rng):
    ff = rng.standard_normal((1, 3, 2, 12, 10)).astype(np.float32)
    bf = rng.standard_normal((1, 3, 2, 12, 10)).astype(np.float32)
    ref = j_rescale_flows(JConfigDict(fflow=jnp.asarray(ff),
                                      bflow=jnp.asarray(bf)), 24, 20)
    got = t_rescale_flows(ConfigDict(fflow=to_torch(ff), bflow=to_torch(bf)),
                          24, 20)
    assert_close(got.fflow, ref.fflow, "fflow")
    assert_close(got.bflow, ref.bflow, "bflow")
    same = ConfigDict(fflow=to_torch(ff), bflow=to_torch(bf))
    assert t_rescale_flows(same, 12, 10) is same


def test_params_from_jax_layouts(rng):
    k = rng.standard_normal((1, 1, 4, 6)).astype(np.float32)
    params = {"params": {
        "qkv": {"to_q": {"kernel": k, "bias": np.ones(6, np.float32)}},
        "norm_layer": {"LayerNorm_0": {"scale": np.ones(4, np.float32),
                                       "bias": np.zeros(4, np.float32)}},
        "proj_w": np.eye(3, dtype=np.float32)}}
    sd = params_from_jax(params)
    assert tuple(sd["qkv.to_q.weight"].shape) == (6, 4, 1, 1)
    assert np.allclose(sd["qkv.to_q.weight"][:, :, 0, 0].numpy(), k[0, 0].T)
    assert tuple(sd["norm_layer.norm.weight"].shape) == (4,)
    assert np.allclose(sd["proj_w"].numpy(), np.eye(3))


def test_port_imports_no_jax():
    code = ("import sys, stnls_tpu_torch, stnls_tpu_torch.attn_step, "
            "stnls_tpu_torch.convert; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'flax', 'stnls_tpu.')) or m == 'stnls_tpu']; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          cwd=Path(__file__).resolve().parents[2])
    assert proc.returncode == 0, proc.stdout + proc.stderr
