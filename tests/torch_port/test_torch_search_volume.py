"""Port parity of the full-volume search path against the JAX package on
the CPU: the anchor and top-K ops (ties included), the plain versions of
the volume kernel B5 and of its backward B6 (ops/nls_vol_cuda) against
stnls_tpu.ops.nls.nls_search_volume and its jax.vjp, and the slice's
NonLocalAttention (anchor_each, per-frame top-K) against the flax module.
NonLocalSearch over the whole self_action x topk_mode menu is in
test_torch_search_menu.py (a file of its own, so that the two run on
separate test workers).

The JAX side runs the exhaustive lattice engine (impl="lattice"): off
the TPU, impl="auto" sends volume configs to the warp engine, which is
not the truth. Values agree to atol = rtol = 1e-4, offsets exactly up to
float rounding (1e-4), gradients to 1e-4 * max|g|."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import stnls_tpu
import stnls_tpu_torch
from stnls_tpu.nn import NonLocalAttention as JAttention
from stnls_tpu.ops import anchor as j_anchor
from stnls_tpu.ops import topk as j_topk
from stnls_tpu.ops.nls import nls_search_volume as j_search_volume
from stnls_tpu.utils.config import ConfigDict as JConfigDict
from stnls_tpu_torch.convert import params_from_jax
from stnls_tpu_torch.nn import NonLocalAttention as TAttention
from stnls_tpu_torch.ops import anchor as t_anchor
from stnls_tpu_torch.ops import topk as t_topk
from stnls_tpu_torch.ops import nls_vol_cuda
from stnls_tpu_torch.ops.nls import search_centres
from stnls_tpu_torch.utils.config import ConfigDict

from torch_port_helpers import to_torch, assert_close, assert_grad_close

B, HD, T, F, H, W = 1, 2, 3, 2, 12, 12
WS, WT = 3, 1


def _tied_volume(rng, shape, int_inds):
    """Dists with many exact ties (a few levels) and offsets whose |.|
    sums tie too, so first-argmin and lower-index-first both matter."""
    d = rng.integers(0, 4, shape).astype(np.float32)
    inds = rng.integers(-2, 3, (3,) + shape)
    return d, (inds if int_inds else 0.5 * inds).astype(
        np.int32 if int_inds else np.float32)


@pytest.mark.parametrize("fn,int_inds", [
    ("anchor_self", True), ("anchor_self", False),
    ("anchor_self_time", True), ("anchor_self_time", False)])
def test_anchor_ops_match_jax(rng, fn, int_inds):
    d, i3 = _tied_volume(rng, (2, 5, 3, 7), int_inds)
    jd, ji, jo = getattr(j_anchor, fn)(jnp.asarray(d), jnp.asarray(i3))
    td, ti, to = getattr(t_anchor, fn)(torch.from_numpy(d),
                                       torch.from_numpy(i3))
    assert ti.dtype == torch.from_numpy(i3).dtype
    for a, b, what in ((td, jd, "dists"), (ti, ji, "inds"), (to, jo,
                                                             "order")):
        assert np.array_equal(a.numpy(), np.asarray(b)), what


@pytest.mark.parametrize("descending", [False, True])
def test_topk_ops_match_jax(rng, descending):
    d, i3 = _tied_volume(rng, (2, 4, 3, 9), False)
    jd, ji = jnp.asarray(d), jnp.asarray(i3)
    td, ti = torch.from_numpy(d), torch.from_numpy(i3)
    cases = [("standard_topk", (4,), {}), ("standard_topk", (-1,), {}),
             ("anchored_topk", (4,), {}), ("topk", (0,), {}),
             ("topk", (3,), {"anchor": True, "return_order": True}),
             ("topk_each", (2,), {}), ("topk_each", (3,),
                                       {"anchor_self": True}),
             ("topk_each", (1,), {"anchor_self": True})]
    for name, args, kw in cases:
        ref = getattr(j_topk, name)(jd, ji, *args, descending, **kw)
        out = getattr(t_topk, name)(td, ti, *args, descending, **kw)
        for a, b in zip(out, ref):
            assert np.array_equal(np.asarray(a), np.asarray(b)), name
    _, _, order = t_topk.standard_topk(td, ti, 5, descending)
    ref_order = j_topk.standard_topk(jd, ji, 5, descending)[2]
    assert np.array_equal(t_topk.apply_topk(td, order).numpy(),
                          np.asarray(j_topk.apply_topk(jd, ref_order)))
    # the nn wrappers: trailing offset components
    tn = stnls_tpu_torch.nn.topk(td, torch.movedim(ti, 0, -1), 3,
                                 anchor=True, descending=descending)
    jn = stnls_tpu.nn.topk(jd, jnp.moveaxis(ji, 0, -1), 3, anchor=True,
                           descending=descending)
    for a, b in zip(tn, jn):
        assert np.array_equal(a.numpy(), np.asarray(b))
    tn = stnls_tpu_torch.nn.anchor_self_time(td, torch.movedim(ti, 0, -1))
    jn = stnls_tpu.nn.anchor_self_time(jd, jnp.moveaxis(ji, 0, -1))
    for a, b in zip(tn, jn):
        assert np.array_equal(a.numpy(), np.asarray(b))


def _videos(rng):
    v0 = rng.standard_normal((B, HD, T, F, H, W)).astype(np.float32)
    v1 = rng.standard_normal((B, HD, T, F, H, W)).astype(np.float32)
    flows = (1.5 * rng.standard_normal((B, 1, T, 2 * WT, 2, H, W))) \
        .astype(np.float32)
    return v0, v1, flows


@pytest.mark.parametrize("ps,itype,dist_type", [
    (3, "float", "l2"), (1, "float", "prod"), (3, "int", "l2"),
    (3, "float", "prod")])
def test_volume_plain_and_its_backward_match_jax_vjp(rng, ps, itype,
                                                     dist_type):
    """B5's plain version at the flows' centres is the lattice volume, and
    B6's plain version, chained to the flows through the centres, is its
    jax.vjp."""
    v0, v1, flows = _videos(rng)
    stride1 = 0.5 if itype == "float" else 1
    kw = dict(ws=WS, wt=WT, ps=ps, stride0=1, stride1=stride1,
              dist_type=dist_type, itype=itype)
    jd, vjp = jax.vjp(lambda a, b, f: j_search_volume(a, b, f, **kw)[0],
                      jnp.asarray(v0), jnp.asarray(v1), jnp.asarray(flows))
    gd = rng.standard_normal(jd.shape).astype(np.float32)
    jg = vjp(jnp.asarray(gd))

    tv0, tv1, tfl = to_torch(v0, True), to_torch(v1, True), \
        to_torch(flows, True)
    ctr_h, ctr_w = search_centres(tv0.shape, tfl, wt=WT, stride0=1,
                                  itype=itype)
    calls = nls_vol_cuda.nls_volume_bwd_plain.calls
    td = nls_vol_cuda.search_volume(tv0, tv1, ctr_h, ctr_w, **kw)
    assert td.shape == (B, HD, T, 2 * WT + 1, WS, WS, H, W)
    assert_close(td, jd, "volume")
    tg = torch.autograd.grad((td * torch.from_numpy(gd)).sum(),
                             (tv0, tv1, tfl))
    assert nls_vol_cuda.nls_volume_bwd_plain.calls == calls + 1
    for a, b, name in zip(tg, jg, ("g_vid0", "g_vid1", "g_flows")):
        assert_grad_close(a, b, name)
    if itype == "float":
        assert float(tg[2].abs().max()) > 0


def test_unported_and_small_frame_configs():
    """The configurations the kernels do not take run the lattice route
    (tests/torch_port/test_torch_search_configs.py holds them to JAX);
    the lazy route's configs on frames too small for its reflect pad take
    the full volume, as in the JAX package."""
    from stnls_tpu_torch.search.non_local_search import search_route
    for kw in ({"pt": 2}, {"reflect_bounds": False}, {"ws_interior": 3},
               {"dilation": 1.5}, {"off_Hq": 1}):
        search = stnls_tpu_torch.search.NonLocalSearch(3, 1, k=4, **kw)
        assert search_route(search.cfg, (1, 1, 4, 2, 16, 16)) == "lattice"
    rng = np.random.default_rng(3)
    vid = rng.standard_normal((1, 2, 4, 4, 4)).astype(np.float32)
    kw = dict(self_action="anchor", stride1=0.5)
    jd, ji = stnls_tpu.search.NonLocalSearch(3, 1, 3, 4, impl="lattice",
                                             **kw)(jnp.asarray(vid),
                                                   jnp.asarray(vid))
    td, ti = stnls_tpu_torch.search.NonLocalSearch(3, 1, 3, 4, **kw)(
        to_torch(vid), to_torch(vid))
    assert_close(td, jd, "dists")
    assert_close(ti, ji, "inds")


def test_slice_attention_matches_flax(rng):
    """The slice's NonLocalAttention (anchor_each, topk_mode="each", k=2:
    K = W_t * k) at a small size: the forward, and the grads into the
    video and the flows."""
    attn_cfg = {"nheads": 2, "embed_dim": 4, "use_attn_projection": True,
                "use_attn_flow": True}
    search_cfg = {"search_name": "nls", "ws": 3, "wt": 1, "ps": 3, "k": 2,
                  "nheads": 2, "stride0": 1, "stride1": 0.5,
                  "self_action": "anchor_each", "topk_mode": "each",
                  "itype": "float", "dist_type": "l2", "impl": "lattice"}
    normz_cfg = {"normz_name": "softmax", "normz_scale": 10,
                 "dist_type": "l2"}
    agg_cfg = {"agg_name": "gather", "ps": 3, "stride0": 1,
               "itype": "float"}
    cfgs = (attn_cfg, search_cfg, normz_cfg, agg_cfg)
    vid = rng.standard_normal((B, T, 8, H, W)).astype(np.float32)
    ff = (2 * rng.standard_normal((B, T, 2, H, W))).astype(np.float32)
    bf = (2 * rng.standard_normal((B, T, 2, H, W))).astype(np.float32)
    jmodel = JAttention(*cfgs)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(vid),
                         JConfigDict(fflow=jnp.asarray(ff),
                                     bflow=jnp.asarray(bf)))

    def jloss(v, f):
        out, _ = jmodel.apply(params, v, JConfigDict(fflow=f,
                                                     bflow=jnp.asarray(bf)))
        return jnp.mean(out ** 2), out

    (_, jout), (jgv, jgf) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(vid),
                                             jnp.asarray(ff))
    tmodel = TAttention(*cfgs)
    tmodel.load_state_dict(params_from_jax(jax.tree.map(np.asarray,
                                                        params)))
    tv, tf = to_torch(vid, True), to_torch(ff, True)
    tout, _ = tmodel(tv, ConfigDict(fflow=tf, bflow=to_torch(bf)))
    assert_close(tout, jout, "NonLocalAttention output")
    gv, gf = torch.autograd.grad(tout.pow(2).mean(), (tv, tf))
    assert float(gf.abs().max()) > 0
    assert_grad_close(gv, jgv, "g_vid")
    assert_grad_close(gf, jgf, "g_fflow")
