"""Port parity of the search's backward: the search Function
(ops/nls_cuda.search_dists) on CPU tensors, whose backward is the plain
version of the B2 kernel (the VJP of ops/nls_k.dists_at_positions),
chained to the flows through ops/nls_k.cells_geometry, against jax.vjp of
stnls_tpu.ops.nls_k.nls_dists_at_cells at the same cells. Gradients
agree to 1e-4 * max|g|."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from stnls_tpu.ops import nls_k as j_nls_k
from stnls_tpu_torch.ops import nls_cuda
from stnls_tpu_torch.ops.nls_k import cells_geometry

from torch_port_helpers import to_torch, assert_close, assert_grad_close

B, HD, T, F, H, W = 1, 2, 3, 4, 24, 24
WS, WT, PS, K = 5, 1, 3, 6


@pytest.mark.parametrize("anchor,itype,dist_type", [
    (True, "float", "l2"), (False, "float", "l2"), (True, "int", "l2"),
    (False, "int", "prod"), (True, "float", "prod"),
    (False, "float", "prod")])
def test_search_backward_plain_matches_jax_vjp(rng, anchor, itype,
                                               dist_type):
    v0 = rng.standard_normal((B, HD, T, F, H, W)).astype(np.float32)
    v1 = rng.standard_normal((B, HD, T, F, H, W)).astype(np.float32)
    flows = (1.5 * rng.standard_normal((B, 1, T, 2 * WT, 2, H, W))) \
        .astype(np.float32)
    stride1 = 0.5 if itype == "float" else 1
    kw = dict(ws=WS, wt=WT, ps=PS, stride0=1, stride1=stride1,
              dist_type=dist_type, itype=itype)
    tv0, tv1, tfl = to_torch(v0, True), to_torch(v1, True), \
        to_torch(flows, True)
    with torch.no_grad():
        d_sel, cells = nls_cuda.nls_topk(tv0, tv1, tfl, k=K, anchor=anchor,
                                         **kw)
    geo = cells_geometry(tfl, cells, H=H, W=W, ws=WS, wt=WT, stride0=1,
                         stride1=stride1, itype=itype)
    calls = nls_cuda.nls_topk_bwd_plain.calls
    td = nls_cuda.search_dists(tv0, tv1, geo["prop_h"], geo["prop_w"], d_sel,
                               geo["tj_k"], geo["valid"], ps=PS,
                               dist_type=dist_type, itype=itype)
    assert torch.equal(td, d_sel)

    jcells = jnp.asarray(cells.numpy())
    jd, vjp = jax.vjp(
        lambda a, b, f: j_nls_k.nls_dists_at_cells(a, b, f, jcells, **kw)[0],
        jnp.asarray(v0), jnp.asarray(v1), jnp.asarray(flows))
    assert_close(td, jd, "dists")
    gd = rng.standard_normal(td.shape).astype(np.float32)
    jg = vjp(jnp.asarray(gd))
    tg = torch.autograd.grad((td * torch.from_numpy(gd)).sum(),
                             (tv0, tv1, tfl))
    assert nls_cuda.nls_topk_bwd_plain.calls == calls + 1
    for a, b, name in zip(tg, jg, ("g_vid0", "g_vid1", "g_flows")):
        assert_grad_close(a, b, name)
    if itype == "float":
        assert float(tg[2].abs().max()) > 0
