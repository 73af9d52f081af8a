"""The twin of examples/agg_example.py (stnls_tpu_torch/agg_example.py)
against the JAX package at 32^2, F=8 (two heads of 4), K=8: its search
against JAX's search, then its four aggregators on JAX's search outputs
(the two searches may pick other cells at a near-tie, so the aggregators
are held on one set of inputs) against JAX's, forward and the grads of
mean(out^2) to the video, the weights and the offsets. Tolerances:
torch_port_helpers."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import stnls_tpu
from stnls_tpu.search.utils import shape_vids
from stnls_tpu_torch import agg_example

from torch_port_helpers import to_torch, assert_close, assert_grad_close, \
    assert_cells_match

CFG = dict(agg_example.CONFIG, F=8, H=32, W=32)


@pytest.fixture(scope="module")
def jax_search():
    """The example's search in the JAX package on the twin's inputs:
    (vid, fflow, bflow, dists, offsets) as numpy."""
    vid, fflow, bflow = (x.numpy() for x in agg_example.make_inputs(
        0, device="cpu", **CFG))
    flows = stnls_tpu.nn.search_flow(jnp.asarray(fflow), jnp.asarray(bflow),
                                     CFG["wt"], 1)
    search = stnls_tpu.search.NonLocalSearch(
        CFG["ws"], CFG["wt"], CFG["ps"], CFG["K"], nheads=CFG["HD"],
        self_action="anchor", itype="float")
    dists, offsets = search(jnp.asarray(vid), jnp.asarray(vid), flows)
    return vid, fflow, bflow, np.asarray(dists), np.asarray(offsets)


def test_twin_search_matches_jax(jax_search):
    vid, fflow, bflow, dists, offsets = jax_search
    d, o = agg_example.search(to_torch(vid), to_torch(fflow), to_torch(bflow),
                              **CFG)
    assert d.shape == dists.shape and o.shape == offsets.shape
    assert_close(d, dists, "dists")
    # a slot's offsets agree, except at a near-tie of the ranked dists
    same = np.isclose(o.numpy(), offsets, atol=1e-4, rtol=1e-4).all(-1)
    assert_cells_match(same, np.ones_like(same), dists)


def _jax_aggregators(ps):
    return {"gather": stnls_tpu.agg.NonLocalGather(ps=ps, stride0=1),
            "gather_add": stnls_tpu.agg.NonLocalGatherAdd(
                ps=ps, strideIn=1, strideOut=1),
            "scatter_add": stnls_tpu.agg.NonLocalScatterAdd(
                ps=ps, strideIn=1, strideOut=1),
            "pool": stnls_tpu.agg.PooledPatchSum(ps=ps, stride0=1)}


@pytest.mark.parametrize("name", agg_example.NAMES)
def test_twin_aggregators_match_jax(jax_search, name):
    vid, _, _, dists, offsets = jax_search
    weights = np.asarray(jax.nn.softmax(-10. * jnp.asarray(dists), axis=-1))
    v6 = np.asarray(shape_vids(CFG["HD"], [jnp.asarray(vid)])[0])
    agg = _jax_aggregators(CFG["ps"])[name]
    ref = agg(jnp.asarray(v6), jnp.asarray(weights), jnp.asarray(offsets))

    def loss(v, w, f):
        return jnp.mean(agg(v, w, f) ** 2)

    # the JAX modules resolve budgets from concrete offsets, so the
    # offsets' JAX gradient is taken through the module's engine
    jg = jax.grad(loss, (0, 1))(jnp.asarray(v6), jnp.asarray(weights),
                                jnp.asarray(offsets))
    res = agg_example.aggregate(to_torch(v6), to_torch(weights),
                                to_torch(offsets), names=(name,), **CFG)
    out, g_vid, g_w, g_off = res[name]
    assert_close(out, ref, f"{name} out")
    assert_grad_close(g_vid, jg[0], f"{name} g_vid")
    assert_grad_close(g_w, jg[1], f"{name} g_weights")
    assert float(g_vid.abs().max()) > 0 and float(g_w.abs().max()) > 0
    if name in ("scatter_add", "pool"):
        # rounded offsets: no gradient
        assert not g_off.any()
    else:
        from stnls_tpu.ops.agg import nl_gather_stack, nl_gather_add
        engine = {"gather": lambda v, w, f: nl_gather_stack(
                      v, w, f, ps=CFG["ps"], stride0=1),
                  "gather_add": lambda v, w, f: nl_gather_add(
                      v, w, f, ps=CFG["ps"], strideIn=1, strideOut=1)}[name]
        jgf = jax.grad(lambda f: jnp.mean(engine(
            jnp.asarray(v6), jnp.asarray(weights), f) ** 2))(
                jnp.asarray(offsets))
        assert_grad_close(g_off, jgf, f"{name} g_offsets")


def test_twin_main_runs_on_cpu():
    res = agg_example.main(["--device", "cpu", "--size", "24"])
    assert set(res) == set(agg_example.NAMES)
    for name, (out, *grads) in res.items():
        assert all(bool(x.isfinite().all()) for x in (out, *grads)), name
    assert res["pool"][0].shape[-2:] == (72, 72)
