"""The lazy route's assembly through ops/nls_geometry_cuda.nls_geometry on
CPU tensors (its plain version) against the composition written out:
ops/nls_k.cells_geometry, ops/nls_cuda.search_dists, the stack of the
offsets and the anchored slot 0. Dists, offsets and the gradients to the
videos and the flows are equal bitwise, and no kernel launches."""

import numpy as np
import pytest
import torch

from stnls_tpu_torch.ops import nls_geometry_cuda
from stnls_tpu_torch.ops.nls_cuda import search_dists
from stnls_tpu_torch.ops.nls_k import cells_geometry
from stnls_tpu_torch.search import non_local_search as nls_mod

B, HD, T, F, H, W = 1, 2, 3, 4, 20, 24
WS, WT, PS, K = 5, 1, 3, 6


def _composed(vid0, vid1, flows, d_sel, cells, cfg):
    """cells_geometry, search_dists, the stacked offsets, slot 0 zeroed
    under an anchored self_action."""
    geo = cells_geometry(flows, cells, H=H, W=W, ws=cfg["ws"], wt=cfg["wt"],
                         stride0=cfg["stride0"], stride1=cfg["stride1"],
                         full_ws=cfg["full_ws"], itype=cfg["itype"])
    d = search_dists(vid0, vid1, geo["prop_h"], geo["prop_w"], d_sel,
                     geo["tj_k"], geo["valid"], ps=cfg["ps"],
                     stride0=cfg["stride0"], dist_type=cfg["dist_type"],
                     dilation=int(cfg["dilation"]), use_adj=cfg["use_adj"],
                     itype=cfg["itype"])
    inds = torch.stack([geo["dt"], geo["dh"], geo["dw"]], dim=-1)
    if cfg["self_action"] in ("anchor", "anchor_self"):
        inds = torch.cat([torch.zeros_like(inds[..., :1, :]),
                          inds[..., 1:, :]], dim=-2)
    return d, inds


@pytest.mark.parametrize("self_action", [None, "anchor"])
@pytest.mark.parametrize("itype", ["float", "int"])
def test_sparse_assemble_equals_the_composition(rng, self_action, itype):
    cfg = nls_mod.NonLocalSearch(
        WS, WT, PS, K, nheads=HD, self_action=self_action, itype=itype,
        stride1=0.5 if itype == "float" else 1).cfg
    v0 = torch.from_numpy(rng.standard_normal((B, HD, T, F, H, W))
                          .astype(np.float32))
    v1 = torch.from_numpy(rng.standard_normal((B, HD, T, F, H, W))
                          .astype(np.float32))
    flows = torch.from_numpy((4. * rng.standard_normal(
        (B, 1, T, 2 * WT, 2, H, W))).astype(np.float32))
    chunk = dict(query_t0=None, T_global=None)
    with torch.no_grad():
        d_sel, cells = nls_mod._select_cells(v0, v1, flows, cfg, chunk)
    g_d = torch.from_numpy(rng.standard_normal(d_sel.shape)
                           .astype(np.float32))
    g_i = torch.from_numpy(rng.standard_normal(tuple(d_sel.shape) + (3,))
                           .astype(np.float32))

    def run(fn):
        args = [x.clone().requires_grad_() for x in (v0, v1, flows)]
        d, inds = fn(*args, d_sel, cells)
        loss = (d * g_d).sum()
        if inds.is_floating_point():
            loss = loss + (inds * g_i).sum()
        return d, inds, torch.autograd.grad(loss, args)

    launches = nls_geometry_cuda.nls_geometry.launches
    d, inds, grads = run(lambda a, b, f, ds, c: nls_mod._sparse_assemble(
        a, b, f, ds, c, cfg, chunk))
    d_r, inds_r, grads_r = run(lambda a, b, f, ds, c: _composed(
        a, b, f, ds, c, cfg))
    assert nls_geometry_cuda.nls_geometry.launches == launches
    assert inds.dtype == (torch.int32 if itype == "int" else torch.float32)
    assert torch.equal(d, d_r) and torch.equal(inds, inds_r)
    if self_action is not None:
        assert not inds[..., 0, :].any()
    for a, b, name in zip(grads, grads_r, ("g_vid0", "g_vid1", "g_flows")):
        assert torch.equal(a, b), name
    # the float path's offsets carry the flows' gradient, the int path's
    # rounded flows none
    assert bool(grads[2].any()) == (itype == "float")


@pytest.mark.parametrize("cotangents", ["all", "positions", "offsets",
                                        "none"])
@pytest.mark.parametrize("anchor", [False, True])
def test_plain_geometry_backward_is_autograd(rng, cotangents, anchor):
    """nls_geometry_bwd_plain, G2's plain version, gives the flows the
    gradient autograd gives them through nls_geometry_plain, from any of
    the cotangents (None: no cotangent), and counts its calls."""
    cells = torch.from_numpy(rng.integers(
        0, (2 * WT + 1) * WS * WS, (B, HD, T, H, W, K)).astype(np.int32))
    flows = torch.from_numpy((4. * rng.standard_normal(
        (B, 1, T, 2 * WT, 2, H, W))).astype(np.float32))
    kw = dict(H=H, W=W, ws=WS, wt=WT, stride0=1, stride1=0.5, full_ws=True,
              itype="float", anchor=anchor, query_t0=None, T_global=None,
              halo=0)
    g_ph, g_pw = (torch.from_numpy(rng.standard_normal(cells.shape)
                                   .astype(np.float32)) for _ in range(2))
    g_inds = torch.from_numpy(rng.standard_normal(tuple(cells.shape) + (3,))
                              .astype(np.float32))
    if cotangents in ("offsets", "none"):
        g_ph = g_pw = None
    if cotangents in ("positions", "none"):
        g_inds = None
    f = flows.clone().requires_grad_()
    ph, pw, _, _, inds = nls_geometry_cuda.nls_geometry_plain(f, cells, **kw)
    loss = sum((o * g).sum() for o, g in ((ph, g_ph), (pw, g_pw),
                                          (inds, g_inds)) if g is not None)
    calls = nls_geometry_cuda.nls_geometry_bwd_plain.calls
    g = nls_geometry_cuda.nls_geometry_bwd_plain(flows, cells, g_ph, g_pw,
                                                 g_inds, **kw)
    assert nls_geometry_cuda.nls_geometry_bwd_plain.calls == calls + 1
    assert g.shape == flows.shape
    if cotangents == "none":
        assert not g.any()
    else:
        assert torch.equal(g, torch.autograd.grad(loss, f)[0])
        assert g.any()
