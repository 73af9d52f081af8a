"""Port parity of the gather: nl_gather_stack_plain (the plain version of
the B3 kernel), _gather_bwd_plain (the plain version of the B4 kernel)
and NonLocalGather, forward and grads to the video, the weights and the
(float) offsets."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import stnls_tpu
import stnls_tpu_torch
from stnls_tpu.ops.agg import nl_gather_stack as j_gather
from stnls_tpu_torch.ops.agg_cuda import (
    nl_gather_stack, nl_gather_stack_plain, _gather_bwd_plain,
)

from torch_port_helpers import to_torch, assert_close, assert_grad_close

B, HD, T, F, H, W, K = 1, 2, 3, 4, 24, 24, 6


def _inputs(rng, nH, nW):
    vid = rng.standard_normal((B, HD, T, F, H, W)).astype(np.float32)
    weights = rng.random((B, HD, T, nH, nW, K)).astype(np.float32)
    dt = rng.integers(-1, 2, (B, HD, T, nH, nW, K))
    dh = 3 * rng.standard_normal((B, HD, T, nH, nW, K))
    dw = 3 * rng.standard_normal((B, HD, T, nH, nW, K))
    flows = np.stack([dt, dh, dw], -1).astype(np.float32)
    return vid, weights, flows


@pytest.mark.parametrize("cfg", [
    dict(), dict(stride0=2), dict(itype="int"), dict(ps=5, dilation=2),
    dict(pt=2, use_adj=True)])
def test_gather_stack_forward_and_grads(rng, cfg):
    kw = dict(dict(ps=3, stride0=1, itype="float"), **cfg)
    itype, stride0 = kw["itype"], kw["stride0"]
    nH, nW = (H - 1) // stride0 + 1, (W - 1) // stride0 + 1
    vid, weights, flows = _inputs(rng, nH, nW)
    ref = j_gather(jnp.asarray(vid), jnp.asarray(weights), jnp.asarray(flows),
                   **kw)
    tv, tw = to_torch(vid, True), to_torch(weights, True)
    tf = to_torch(flows, itype == "float")
    out = nl_gather_stack_plain(tv, tw, tf, **kw)
    assert out.shape == ref.shape
    assert_close(out, ref, "stack")
    # on CPU tensors the kernel wrapper is its plain version
    assert torch.equal(nl_gather_stack(tv, tw, tf, **kw), out)

    g = rng.standard_normal(ref.shape).astype(np.float32)
    argnums = (0, 1, 2) if itype == "float" else (0, 1)
    jg = jax.grad(lambda a, b, c: jnp.sum(j_gather(a, b, c, **kw) * g),
                  argnums=argnums)(jnp.asarray(vid), jnp.asarray(weights),
                                   jnp.asarray(flows))
    tg = torch.autograd.grad((out * torch.from_numpy(g)).sum(),
                             (tv, tw, tf)[:len(argnums)])
    for a, b, name in zip(tg, jg, ("g_vid", "g_weights", "g_flows")):
        assert_grad_close(a, b, name)
    # B4's plain version on the same cotangent: the same grads, and a
    # zero offset gradient where the offsets are integers
    needs = (True, True, True)
    bg = _gather_bwd_plain(tv, tw, tf, torch.from_numpy(g), kw, needs)
    for a, b, name in zip(bg, jg, ("B4 g_vid", "B4 g_weights", "B4 g_flows")):
        assert_grad_close(a, b, name)
    if itype == "int":
        assert not bg[2].any()


def test_non_local_gather_module(rng):
    """5-D video, head split by the weights, menu construction."""
    vid, weights, flows = _inputs(rng, H, W)
    vid5 = vid.transpose(0, 2, 1, 3, 4, 5).reshape(B, T, HD * F, H, W)
    cfg = {"agg_name": "gather", "ps": 3, "stride0": 1, "itype": "float"}
    ref = stnls_tpu.agg.init(cfg)(jnp.asarray(vid5), jnp.asarray(weights),
                                  jnp.asarray(flows))
    out = stnls_tpu_torch.agg.init(cfg)(to_torch(vid5), to_torch(weights),
                                        to_torch(flows))
    assert_close(out, ref, "NonLocalGather")
    assert isinstance(stnls_tpu_torch.agg.init({"agg_name": "scatter"}),
                      stnls_tpu_torch.agg.NonLocalScatter)
