"""Port parity of the aggregation menu against the JAX package: the
engines nl_gather_add, nl_scatter_add (out and counts),
scatter_add_counts and nl_pool, forward and grads to the video and the
weights; the plain versions of B7-B10 (nl_scatter_add_plain,
_scatter_add_bwd_plain, nl_pool_plain, _pool_bwd_plain) and the kernel
wrappers on CPU tensors; and NonLocalGatherAdd, NonLocalScatterAdd,
PooledPatchSum through agg.init for every menu name they cover.

The offsets include exact half-integers (both packages round half to
even: 0.5 -> 0, 1.5 -> 2), -1e8 fills of (dh, dw), and the weights values
below 1e-8 and negative ones (PooledPatchSum zeroes both). Tolerances:
torch_port_helpers (1e-4; gradients 1e-4 * max|g|)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import stnls_tpu
import stnls_tpu_torch
from stnls_tpu.ops import agg as J
from stnls_tpu.ops.agg_pallas_sp import scatter_add_counts as j_counts
from stnls_tpu_torch.ops import agg as P
from stnls_tpu_torch.ops import agg_sp_cuda

from torch_port_helpers import to_torch, assert_close, assert_grad_close

B, HD, T, F, H, W, K = 1, 2, 3, 4, 20, 20, 5

# ps in {3, 4} (pool runs 4 as 5), strideIn = strideOut in {1, 2},
# dilation in {1, 2}, use_adj, pt in {1, 2}, reflect_bounds
CASES = {
    "ps3": dict(ps=3, stride=1, dilation=1, use_adj=False, pt=1),
    "ps4-s2-adj": dict(ps=4, stride=2, dilation=1, use_adj=True, pt=1),
    "ps3-s2-dil2-pt2": dict(ps=3, stride=2, dilation=2, use_adj=False, pt=2),
    "ps4-dil2-adj-pt2": dict(ps=4, stride=1, dilation=2, use_adj=True, pt=2),
    "ps3-noreflect": dict(ps=3, stride=1, dilation=1, use_adj=False, pt=1,
                          reflect_bounds=False),
}


def _inputs(rng, stride):
    nH, nW = (H - 1) // stride + 1, (W - 1) // stride + 1
    vid = rng.standard_normal((B, HD, T, F, H, W)).astype(np.float32)
    weights = rng.random((B, HD, T, nH, nW, K)).astype(np.float32)
    weights[..., 0] = -0.25                  # negative
    weights[..., 1] = 5e-9                   # below 1e-8
    flows = np.stack([rng.integers(-1, 2, (B, HD, T, nH, nW, K)),
                      3 * rng.standard_normal((B, HD, T, nH, nW, K)),
                      3 * rng.standard_normal((B, HD, T, nH, nW, K))],
                     -1).astype(np.float32)
    # exact half-integers, rounded half to even
    flows[..., 2, 1], flows[..., 2, 2] = 0.5, -1.5
    flows[..., 3, 1], flows[..., 3, 2] = 1.5, -0.5
    # the search's -1e8 invalid fill in (dh, dw)
    flows[:, :, 1, 1::3, ::2, 4, 1:] = -1e8
    return vid, weights, flows


def _kw(case):
    return dict(ps=case["ps"], pt=case["pt"], dilation=case["dilation"],
                use_adj=case["use_adj"],
                reflect_bounds_=case.get("reflect_bounds", True))


def _wrapper_kw(kw):
    kw = dict(kw)
    kw["reflect_bounds"] = kw.pop("reflect_bounds_")
    return kw


def _check_vjp(rng, j_fn, t_fn, vid, weights, flows, what, offsets=True):
    """Forward of t_fn (torch) against j_fn (JAX) and the grads of
    sum(out * g) to the video, the weights and, with `offsets`, the
    offsets (0 where they are rounded). Returns the torch output, the
    cotangent and the JAX grads."""
    jargs = (jnp.asarray(vid), jnp.asarray(weights), jnp.asarray(flows))
    ref = j_fn(*jargs)
    leaves = (to_torch(vid, True), to_torch(weights, True),
              to_torch(flows, offsets))
    out = t_fn(*leaves)
    assert out.shape == ref.shape
    assert_close(out, ref, f"{what} forward")
    g = rng.standard_normal(ref.shape).astype(np.float32)
    argnums = (0, 1, 2) if offsets else (0, 1)
    jg = jax.grad(lambda a, b, c: jnp.sum(j_fn(a, b, c) * g),
                  argnums=argnums)(*jargs)
    tg = torch.autograd.grad((out * torch.from_numpy(g)).sum(),
                             leaves[:len(argnums)], allow_unused=True,
                             materialize_grads=True)
    for a, b, name in zip(tg, jg, ("g_vid", "g_weights", "g_flows")):
        assert_grad_close(a, b, f"{what} {name}")
    assert float(np.abs(np.asarray(jg[0])).max()) > 0
    assert float(np.abs(np.asarray(jg[1])).max()) > 0
    return out, g, jg


@pytest.mark.parametrize("name,itype", [
    ("ps3", "float"), ("ps3-s2-dil2-pt2", "int"),
    ("ps4-dil2-adj-pt2", "float"), ("ps3-noreflect", "float")])
def test_gather_add_engine(rng, name, itype):
    case = CASES[name]
    s = case["stride"]
    vid, weights, flows = _inputs(rng, s)
    kw = dict(_kw(case), strideIn=s, strideOut=s, itype=itype)
    _, _, jg = _check_vjp(
        rng, lambda a, b, c: J.nl_gather_add(a, b, c, **kw),
        lambda a, b, c: P.nl_gather_add(a, b, c, **kw),
        vid, weights, flows, f"nl_gather_add {name} {itype}")
    assert np.asarray(jg[2]).any() == (itype == "float")


@pytest.mark.parametrize("name", list(CASES))
def test_scatter_add_engine_and_plain_versions(rng, name):
    case = CASES[name]
    s = case["stride"]
    vid, weights, flows = _inputs(rng, s)
    kw = dict(_kw(case), strideIn=s, strideOut=s)
    out, g, jg = _check_vjp(
        rng, lambda a, b, c: J.nl_scatter_add(a, b, c, **kw)[0],
        lambda a, b, c: P.nl_scatter_add(a, b, c, **kw)[0],
        vid, weights, flows, f"nl_scatter_add {name}")
    # the rounded offsets get no gradient in either package
    assert not np.asarray(jg[2]).any()
    _, j_cnt = J.nl_scatter_add(jnp.asarray(vid), jnp.asarray(weights),
                                jnp.asarray(flows), **kw)
    _, t_cnt = P.nl_scatter_add(to_torch(vid), to_torch(weights),
                                to_torch(flows), **kw)
    assert_close(t_cnt, j_cnt, "counts")
    assert float(t_cnt.sum()) > 0
    # B7's wrapper on CPU tensors is its plain version; B8's plain version
    # gives the JAX grads on the same cotangent
    wkw = _wrapper_kw(kw)
    tv, tw, tf = to_torch(vid), to_torch(weights), to_torch(flows)
    assert torch.equal(agg_sp_cuda.nl_scatter_add(tv, tw, tf, **wkw), out)
    cfg = dict(wkw, outH=H, outW=W)
    n0 = agg_sp_cuda._scatter_add_bwd_plain.calls
    bg = agg_sp_cuda.nl_scatter_add_bwd(tv, tw, tf, torch.from_numpy(g), cfg,
                                        (True, True, True))
    assert agg_sp_cuda._scatter_add_bwd_plain.calls == n0 + 1
    for a, b, what in zip(bg, jg, ("B8 g_vid", "B8 g_weights")):
        assert_grad_close(a, b, what)
    assert not bg[2].any()


@pytest.mark.parametrize("op", ["gather_add", "scatter_add"])
@pytest.mark.parametrize("strideIn,strideOut,outH,outW", [
    (2, 1, 0, 0), (1, 2, 0, 0), (1, 2, 16, 28)])
def test_unequal_strides_and_output_size(rng, op, strideIn, strideOut,
                                         outH, outW):
    """strideIn != strideOut and an explicit output size, which B7/B8 take
    as they come: both engines against JAX, and B7's wrapper (its plain
    version here) equal to the engine."""
    vid, weights, flows = _inputs(rng, strideIn)
    kw = dict(ps=3, strideIn=strideIn, strideOut=strideOut, outH=outH,
              outW=outW)
    j_fn, t_fn = {
        "gather_add": (J.nl_gather_add, P.nl_gather_add),
        "scatter_add": (lambda *a, **k: J.nl_scatter_add(*a, **k)[0],
                        lambda *a, **k: P.nl_scatter_add(*a, **k)[0])}[op]
    out, _, _ = _check_vjp(
        rng, lambda a, b, c: j_fn(a, b, c, **kw),
        lambda a, b, c: t_fn(a, b, c, **kw), vid, weights, flows,
        f"nl_{op} {strideIn}->{strideOut} out {outH}x{outW}")
    if op == "scatter_add":
        assert torch.equal(agg_sp_cuda.nl_scatter_add(
            to_torch(vid), to_torch(weights), to_torch(flows), **kw), out)


@pytest.mark.parametrize("name", list(CASES))
def test_pool_engine_and_plain_versions(rng, name):
    case = CASES[name]
    s = case["stride"]
    vid, weights, flows = _inputs(rng, s)
    kw = dict(_kw(case), stride0=s)
    out, g, jg = _check_vjp(
        rng, lambda a, b, c: J.nl_pool(a, b, c, **kw),
        lambda a, b, c: P.nl_pool(a, b, c, **kw),
        vid, weights, flows, f"nl_pool {name}")
    ps = case["ps"] + (1 - case["ps"] % 2)
    nH = (H - 1) // s + 1
    assert out.shape[-2:] == (ps * nH, ps * nH)
    # zeroed weights (below 1e-8, negative) get no gradient; nor do the
    # rounded offsets
    assert not np.asarray(jg[1])[..., :2].any()
    assert not np.asarray(jg[2]).any()
    wkw = _wrapper_kw(kw)
    tv, tw, tf = to_torch(vid), to_torch(weights), to_torch(flows)
    assert torch.equal(agg_sp_cuda.nl_pool(tv, tw, tf, **wkw), out)
    n0 = agg_sp_cuda._pool_bwd_plain.calls
    bg = agg_sp_cuda.nl_pool_bwd(tv, tw, tf, torch.from_numpy(g), wkw,
                                 (True, True, True))
    assert agg_sp_cuda._pool_bwd_plain.calls == n0 + 1
    for a, b, what in zip(bg, jg, ("B10 g_vid", "B10 g_weights")):
        assert_grad_close(a, b, what)
    assert not bg[1][..., :2].any() and not bg[2].any()


@pytest.mark.parametrize("name", ["ps3", "ps4-s2-adj", "ps3-noreflect"])
def test_scatter_add_counts(rng, name):
    case = CASES[name]
    s = case["stride"]
    _, _, flows = _inputs(rng, s)
    nH = (H - 1) // s + 1
    kw = dict(T=T, nH=nH, nW=nH, H=H, W=W, outH=H, outW=W, ps=case["ps"],
              strideIn=s, strideOut=s, dilation=case["dilation"],
              use_adj=case["use_adj"],
              reflect_bounds_=case.get("reflect_bounds", True))
    ref = j_counts(jnp.asarray(flows), **kw)
    out = agg_sp_cuda.scatter_add_counts(to_torch(flows), **kw)
    assert_close(out, ref, "counts")


def test_fills_are_dropped(rng):
    """A -1e8 fill of all three offsets adds nothing: ScatterAdd and Pool
    equal their outputs with that entry's weight 0, and stay finite (the
    JAX pool engine turns a fill of dt into NaN; its TPU route zeroes the
    entry, as the port does)."""
    vid, weights, flows = _inputs(rng, 1)
    flows[0, 1, 2, 3:9, 4, 2, :] = -1e8
    zeroed = weights.copy()
    zeroed[np.abs(flows[..., 1]) >= 1e7] = 0.
    tv, tf = to_torch(vid), to_torch(flows)
    for fn, kw in ((agg_sp_cuda.nl_scatter_add, dict(strideIn=1, strideOut=1)),
                   (agg_sp_cuda.nl_pool, dict(stride0=1))):
        out = fn(tv, to_torch(weights), tf, ps=3, **kw)
        assert bool(out.isfinite().all())
        assert_close(out, fn(tv, to_torch(zeroed), tf, ps=3, **kw),
                     fn.__name__)


MENU = {
    "gather_add": {"strideIn": 1, "strideOut": 1},
    "scatter_add": {"strideIn": 1, "strideOut": 1},
    "scatter_sum": {"strideIn": 2, "strideOut": 2, "use_adj": True},
    "pool": {"stride0": 1},
    "wpsum": {"stride0": 2, "dilation": 2},
}


@pytest.mark.parametrize("agg_name", list(MENU))
def test_menu_modules(rng, agg_name):
    """agg.init of every menu name the three modules cover, on a 5-D video
    whose heads the weights split, against the JAX module: forward and
    grads to the video and the weights. GatherAdd at strideIn = strideOut
    runs as the K-sum of the gather stack (B3/B4) in the port and as the
    engine in the JAX package on the CPU."""
    cfg = dict({"agg_name": agg_name, "ps": 3}, **MENU[agg_name])
    s = cfg.get("strideIn", cfg.get("stride0"))
    vid, weights, flows = _inputs(rng, s)
    vid5 = vid.transpose(0, 2, 1, 3, 4, 5).reshape(B, T, HD * F, H, W)
    j_mod = stnls_tpu.agg.init(cfg)
    t_mod = stnls_tpu_torch.agg.init(cfg)
    assert type(t_mod).__name__ == type(j_mod).__name__
    # the JAX modules resolve budgets from concrete offsets: no offset grads
    _check_vjp(rng, j_mod, t_mod, vid5, weights, flows, agg_name,
               offsets=False)


def test_gather_add_routes_agree(rng):
    """The two routes of NonLocalGatherAdd compute one function: the K-sum
    of the gather stack (B3's plain version here) and the engine."""
    from stnls_tpu_torch.agg.gather_add import gather_route, \
        non_local_gather_add
    vid, weights, flows = _inputs(rng, 1)
    assert gather_route(3, 1, 1, 0, 0, 1, True, H, W)
    assert not gather_route(3, 1, 1, 0, 0, 2, True, H, W)
    args = (to_torch(vid), to_torch(weights), to_torch(flows))
    out = non_local_gather_add(*args, ps=3, strideIn=1, strideOut=1)
    eng = P.nl_gather_add(*args, ps=3, strideIn=1, strideOut=1)
    assert_close(out, eng, "stack K-sum vs engine")


def test_menu_resolves_every_ported_name():
    for name in ("wpsum", "pool", "gather", "nlgather", "nlstack",
                 "gather_add", "scatter_add", "scatter_sum"):
        stnls_tpu_torch.agg.init({"agg_name": name})
    for name in ("scatter", "stack_conv"):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            stnls_tpu_torch.agg.init({"agg_name": name})
    assert stnls_tpu_torch.agg.WeightedPatchSum is \
        stnls_tpu_torch.agg.PooledPatchSum
