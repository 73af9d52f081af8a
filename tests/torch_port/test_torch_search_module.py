"""Port parity of NonLocalSearch end to end (select + recompute), forward
and grads to both videos and the flows, including the k_agg /
normalize_bwd gradient policy, and the not-yet-ported guard (the full
self_action / topk_mode menu: test_torch_search_menu.py)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import stnls_tpu
import stnls_tpu_torch

from torch_port_helpers import (
    to_torch, assert_close, assert_grad_close, assert_cells_match,
)

B, HD, T, F, H, W = 1, 2, 3, 4, 24, 24


def _run_both(rng, grad_policy):
    v0 = rng.standard_normal((B, T, HD * F, H, W)).astype(np.float32)
    v1 = rng.standard_normal((B, T, HD * F, H, W)).astype(np.float32)
    flows = (1.5 * rng.standard_normal((B, T, 2, 2, H, W))).astype(np.float32)
    kw = dict(dict(nheads=HD, stride0=1, stride1=0.5, self_action="anchor",
                   itype="float"), **grad_policy)
    jsearch = stnls_tpu.search.NonLocalSearch(5, 1, 3, 6, impl="lattice",
                                              **kw)
    tsearch = stnls_tpu_torch.search.NonLocalSearch(5, 1, 3, 6, **kw)
    gd = rng.standard_normal((B, HD, T, H, W, 6)).astype(np.float32)
    gi = rng.standard_normal((B, HD, T, H, W, 6, 3)).astype(np.float32)

    def jloss(a, b, f):
        d, i = jsearch(a, b, f)
        return jnp.sum(d * gd) + jnp.sum(i * gi), (d, i)

    (_, (jd, ji)), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(
        jnp.asarray(v0), jnp.asarray(v1), jnp.asarray(flows))
    tv0, tv1, tfl = to_torch(v0, True), to_torch(v1, True), to_torch(flows,
                                                                      True)
    td, ti = tsearch(tv0, tv1, tfl)
    loss = (td * torch.from_numpy(gd)).sum() + (ti * torch.from_numpy(gi)).sum()
    tg = torch.autograd.grad(loss, (tv0, tv1, tfl))
    return (jd, ji, jg), (td, ti, tg)


@pytest.mark.parametrize("grad_policy", [
    {}, {"k_agg": 3, "normalize_bwd": True, "stride1": 1}])
def test_non_local_search_forward_and_grads(rng, grad_policy):
    (jd, ji, jg), (td, ti, tg) = _run_both(rng, grad_policy)
    assert td.shape == jd.shape and ti.shape == ji.shape
    assert_close(td, jd, "dists")
    assert_close(ti, ji, "inds")
    for a, b, name in zip(tg, jg, ("g_vid0", "g_vid1", "g_flows")):
        assert_grad_close(a, b, name)


def test_fused_flows_and_menu(rng):
    """search(vid0, vid1, fflow, bflow) composes the flows itself; the menu
    builds the module; dists agree with the JAX default (warp) route up to
    near-ties of the selection."""
    vid = rng.standard_normal((B, T, HD * F, H, W)).astype(np.float32)
    ff = (2 * rng.standard_normal((B, T, 2, H, W))).astype(np.float32)
    bf = (2 * rng.standard_normal((B, T, 2, H, W))).astype(np.float32)
    cfg = {"search_name": "nls", "ws": 5, "wt": 1, "ps": 3, "k": 5,
           "nheads": HD, "stride1": 0.5, "self_action": "anchor"}
    jd, ji = stnls_tpu.search.init(cfg)(*map(jnp.asarray, (vid, vid, ff, bf)))
    td, ti = stnls_tpu_torch.search.init(cfg)(*map(to_torch,
                                                   (vid, vid, ff, bf)))
    assert_close(td, jd, "dists")
    assert_cells_match(ti[..., 2], np.asarray(ji)[..., 2], jd)


def test_unported_configs_raise():
    """Nothing in the search menu raises NotImplementedError any more:
    the configurations the kernels do not take build (and run the lattice
    route), and every flavour resolves."""
    stnls_tpu_torch.search.NonLocalSearch(5, 1, k=4, pt=2)
    stnls_tpu_torch.search.NonLocalSearch(5, 1, k=4, reflect_bounds=False)
    assert isinstance(stnls_tpu_torch.search.init({"search_name": "refine"}),
                      stnls_tpu_torch.search.RefineSearch)
    # the volume path runs the rest of the menu
    stnls_tpu_torch.search.NonLocalSearch(5, 1, k=4, topk_mode="each")
    stnls_tpu_torch.search.NonLocalSearch(5, 1, k=4, self_action="remove")
