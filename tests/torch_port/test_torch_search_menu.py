"""Port parity of NonLocalSearch over the whole self_action x topk_mode
menu (7 self_actions; topk_mode "all" with k > 0 and with k = -1, "each"
and "none"), in float and int, against the JAX package's exhaustive
lattice engine (impl="lattice") on the CPU: dists and offsets to atol =
rtol = 1e-4, grads into both videos and the flows to 1e-4 * max|g|. The
lazy top-K configs go through the B1/B2 route, the others through the
volume route (B5/B6); on CPU tensors each kernel runs its plain
version."""

import itertools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import stnls_tpu
import stnls_tpu_torch

from torch_port_helpers import to_torch, assert_close, assert_grad_close

B, HD, T, F, H, W = 1, 2, 3, 2, 12, 12
WS, WT = 3, 1
SELF_ACTIONS = [None, "anchor", "anchor_self", "anchor_each", "remove",
                "remove_ref_frame", "anchor_and_remove_ref_frame"]
TOPK = [("all", 4), ("all", -1), ("each", 2), ("none", -1)]


def _search_both(rng, kw, k, ws=WS, ps=3):
    nH, nW = -(-H // kw.get("stride0", 1)), -(-W // kw.get("stride0", 1))
    v0 = rng.standard_normal((B, T, HD * F, H, W)).astype(np.float32)
    v1 = rng.standard_normal((B, T, HD * F, H, W)).astype(np.float32)
    flows = (1.5 * rng.standard_normal((B, T, 2 * WT, 2, nH, nW))) \
        .astype(np.float32)
    jsearch = stnls_tpu.search.NonLocalSearch(ws, WT, ps, k, impl="lattice",
                                              **kw)
    tsearch = stnls_tpu_torch.search.NonLocalSearch(ws, WT, ps, k, **kw)
    tv0, tv1, tfl = to_torch(v0, True), to_torch(v1, True), \
        to_torch(flows, True)
    td, ti = tsearch(tv0, tv1, tfl)
    gd = rng.standard_normal(tuple(td.shape)).astype(np.float32)
    gi = rng.standard_normal(tuple(ti.shape)).astype(np.float32)

    def jloss(a, b, f):
        d, i = jsearch(a, b, f)
        return (jnp.sum(jnp.where(jnp.isfinite(d), d * gd, 0.))
                + jnp.sum(i * gi)), (d, i)

    (_, (jd, ji)), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(
        jnp.asarray(v0), jnp.asarray(v1), jnp.asarray(flows))
    loss = torch.where(td.isfinite(), td * torch.from_numpy(gd), 0.).sum() \
        + (ti * torch.from_numpy(gi)).sum()
    tg = torch.autograd.grad(loss, (tv0, tv1, tfl))
    return (jd, ji, jg), (td, ti, tg)


@pytest.mark.parametrize("self_action,topk,itype", list(itertools.product(
    SELF_ACTIONS, TOPK, ["float", "int"])))
def test_non_local_search_menu_matches_jax(rng, self_action, topk, itype):
    topk_mode, k = topk
    kw = dict(nheads=HD, stride0=1, stride1=0.5 if itype == "float" else 1,
              self_action=self_action, topk_mode=topk_mode, itype=itype)
    (jd, ji, jg), (td, ti, tg) = _search_both(rng, kw, k)
    assert td.shape == jd.shape and ti.shape == ji.shape
    assert_close(td, jd, "dists")
    assert_close(ti, ji, "inds")
    for a, b, name in zip(tg, jg, ("g_vid0", "g_vid1", "g_flows")):
        assert_grad_close(a, b, name)


# the wider sweep: window, patch, distance and lattice knobs beyond the
# tier-1 grid, on a few menu entries. use_adj goes with ps=1 only: a ps=3
# patch at use_adj whose middle tap is a border pixel reads the same
# pixels, mirrored, from the two cells the border reflects onto each
# other, so their dists tie exactly and each package's summation order
# picks the winner.
WIDE = [dict(ws=5, ps=1, dist_type="prod", use_adj=True),
        dict(ws=3, ps=3, stride0=2, dilation=2),
        dict(ws=5, ps=3, full_ws=False)]


@pytest.mark.slow
@pytest.mark.parametrize("knobs", WIDE)
@pytest.mark.parametrize("self_action,topk", [
    ("anchor_each", ("each", 2)), ("remove", ("all", 5)),
    ("anchor_and_remove_ref_frame", ("all", -1)), (None, ("none", -1))])
@pytest.mark.parametrize("itype", ["float", "int"])
def test_non_local_search_menu_wide_matches_jax(rng, knobs, self_action,
                                                topk, itype):
    topk_mode, k = topk
    knobs = dict(knobs)
    ws, ps = knobs.pop("ws"), knobs.pop("ps")
    kw = dict(knobs, nheads=HD, stride1=0.75 if itype == "float" else 1,
              self_action=self_action, topk_mode=topk_mode, itype=itype)
    (jd, ji, jg), (td, ti, tg) = _search_both(rng, kw, k, ws=ws, ps=ps)
    assert td.shape == jd.shape and ti.shape == ji.shape
    assert_close(td, jd, "dists")
    assert_close(ti, ji, "inds")
    for a, b, name in zip(tg, jg, ("g_vid0", "g_vid1", "g_flows")):
        assert_grad_close(a, b, name)
