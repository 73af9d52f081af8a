"""Port parity of the search's selection and recompute: nls_topk_plain
(the plain version of the B1 kernel) against JAX `_select_cells` on the
exhaustive lattice route, and nls_dists_at_cells forward and grads."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from stnls_tpu.search.non_local_search import _select_cells
from stnls_tpu.ops import nls_k as j_nls_k
from stnls_tpu_torch.ops.nls_cuda import nls_topk, nls_topk_plain
from stnls_tpu_torch.ops import nls_k as t_nls_k

from torch_port_helpers import (
    to_torch, assert_close, assert_grad_close, assert_cells_match,
)

B, HD, T, F, H, W = 1, 2, 3, 4, 24, 24
WS, WT, PS, K = 5, 1, 3, 6


def _inputs(rng):
    v0 = rng.standard_normal((B, HD, T, F, H, W)).astype(np.float32)
    v1 = rng.standard_normal((B, HD, T, F, H, W)).astype(np.float32)
    flows = (1.5 * rng.standard_normal((B, 1, T, 2 * WT, 2, H, W))) \
        .astype(np.float32)
    return v0, v1, flows


def _jax_cfg(anchor, itype, stride1):
    return dict(ws=WS, wt=WT, ps=PS, k=K, stride0=1, stride1=stride1,
                dist_type="l2", dilation=1, pt=1,
                self_action="anchor" if anchor else None, topk_mode="all",
                ws_interior=0, reflect_bounds=True, full_ws=True,
                use_adj=False, off_Hq=0, off_Wq=0, strideQ=None,
                itype=itype, impl="lattice")


@pytest.mark.parametrize("anchor,itype,extra", [
    (True, "float", {}), (False, "float", {}), (True, "int", {}),
    (False, "int", {}), (True, "float", {"dilation": 2}),
    (True, "float", {"dist_type": "prod", "stride0": 2})])
def test_topk_plain_matches_jax_select(rng, anchor, itype, extra):
    v0, v1, flows = _inputs(rng)
    stride1 = 0.5 if itype == "float" else 1
    stride0 = extra.get("stride0", 1)
    flows = np.ascontiguousarray(flows[..., ::stride0, ::stride0])
    cfg = dict(_jax_cfg(anchor, itype, stride1), **extra)
    ref_cells = np.asarray(_select_cells(
        jnp.asarray(v0), jnp.asarray(v1), jnp.asarray(flows), cfg))
    kw = dict(ws=WS, wt=WT, ps=PS, stride1=stride1, itype=itype,
              **{key: cfg[key] for key in ("stride0", "dist_type",
                                           "dilation")})
    ref_d, _ = j_nls_k.nls_dists_at_cells(
        jnp.asarray(v0), jnp.asarray(v1), jnp.asarray(flows),
        jnp.asarray(ref_cells), **kw)
    kw.update(k=K, anchor=anchor)
    d, cells = nls_topk_plain(to_torch(v0), to_torch(v1), to_torch(flows),
                              **kw)
    assert cells.dtype == torch.int32 and cells.shape == ref_cells.shape
    assert_cells_match(cells, ref_cells, ref_d)
    assert_close(d, ref_d, "ranked dists")
    # on CPU tensors the kernel wrapper is its plain version
    d2, cells2 = nls_topk(to_torch(v0), to_torch(v1), to_torch(flows), **kw)
    assert torch.equal(cells2, cells) and torch.equal(d2, d)


@pytest.mark.parametrize("itype", ["float", "int"])
def test_dists_at_cells_forward_and_grads(rng, itype):
    v0, v1, flows = _inputs(rng)
    stride1 = 0.5 if itype == "float" else 1
    S = (2 * WT + 1) * WS * WS
    cells = rng.integers(0, S, (B, HD, T, H, W, K)).astype(np.int32)
    kw = dict(ws=WS, wt=WT, ps=PS, stride0=1, stride1=stride1, itype=itype)

    def jfn(a, b, f):
        d, (_, dh, dw) = j_nls_k.nls_dists_at_cells(a, b, f,
                                                    jnp.asarray(cells), **kw)
        return d, dh, dw

    jd, jdh, jdw = jfn(jnp.asarray(v0), jnp.asarray(v1), jnp.asarray(flows))
    tv0, tv1 = to_torch(v0, True), to_torch(v1, True)
    tfl = to_torch(flows, itype == "float")
    td, (_, tdh, tdw) = t_nls_k.nls_dists_at_cells(
        tv0, tv1, tfl, torch.from_numpy(cells), **kw)
    assert_close(td, jd, "dists")
    assert_close(tdh, jdh, "dh")
    assert_close(tdw, jdw, "dw")

    gd = rng.standard_normal(td.shape).astype(np.float32)
    if itype == "int":
        jg = jax.grad(lambda a, b: jnp.sum(jfn(a, b, jnp.asarray(flows))[0]
                                           * gd), argnums=(0, 1))(
            jnp.asarray(v0), jnp.asarray(v1))
        tg = torch.autograd.grad((td * torch.from_numpy(gd)).sum(),
                                 (tv0, tv1))
    else:
        gh = rng.standard_normal(td.shape).astype(np.float32)

        def jloss(a, b, f):
            d, dh, dw = jfn(a, b, f)
            return jnp.sum(d * gd) + jnp.sum(dh * gh) + jnp.sum(dw * gd)

        jg = jax.grad(jloss, argnums=(0, 1, 2))(
            jnp.asarray(v0), jnp.asarray(v1), jnp.asarray(flows))
        loss = (td * torch.from_numpy(gd)).sum() \
            + (tdh * torch.from_numpy(gh)).sum() \
            + (tdw * torch.from_numpy(gd)).sum()
        tg = torch.autograd.grad(loss, (tv0, tv1, tfl))
    for a, b, name in zip(tg, jg, ("g_vid0", "g_vid1", "g_flows")):
        assert_grad_close(a, b, name)
