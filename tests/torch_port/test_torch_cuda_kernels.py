"""The hand-written CUDA kernels against their plain versions, on the
card. Marked `cuda`: they skip where there is no NVIDIA GPU. This file
imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/torch_port/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from stnls_tpu_torch.ops import agg_cuda, agg_sp_cuda, nls_cuda, nls_vol_cuda
from stnls_tpu_torch.ops.nls_k import nls_dists_at_cells, cells_geometry

from torch_port_helpers import assert_close, assert_grad_close, \
    assert_cells_match, halo_chunk

pytestmark = pytest.mark.cuda
B, HD, T, F, H, W = 1, 2, 3, 8, 32, 32
KW = dict(ws=5, wt=1, ps=3, stride0=1, stride1=0.5, k=6, anchor=True)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _inputs(dev, seed=0):
    rng = np.random.default_rng(seed)

    def t(x):
        return torch.from_numpy(x.astype(np.float32)).to(dev)

    v0 = t(rng.standard_normal((B, HD, T, F, H, W)))
    v1 = t(rng.standard_normal((B, HD, T, F, H, W)))
    flows = t(1.5 * rng.standard_normal((B, 1, T, 2, 2, H, W)))
    return v0, v1, flows


@pytest.mark.parametrize("anchor,itype", [(True, "float"), (False, "float"),
                                          (True, "int")])
def test_search_kernel_matches_plain(dev, anchor, itype):
    v0, v1, flows = _inputs(dev)
    kw = dict(KW, anchor=anchor, itype=itype,
              stride1=0.5 if itype == "float" else 1)
    n0 = nls_cuda.nls_topk.launches
    d, cells = nls_cuda.nls_topk(v0, v1, flows, **kw)
    assert nls_cuda.nls_topk.launches == n0 + 1
    d_p, cells_p = nls_cuda.nls_topk_plain(v0, v1, flows, **kw)
    assert_cells_match(cells, cells_p, d_p)
    assert_close(d, d_p, "dists")


def test_gather_kernel_forward_and_backward(dev):
    v0, v1, flows = _inputs(dev, 1)
    d, cells = nls_cuda.nls_topk(v0, v1, flows, **KW)
    d, (dt, dh, dw) = nls_dists_at_cells(v0, v1, flows, cells,
                                         **{k: KW[k] for k in
                                            ("ws", "wt", "ps", "stride0",
                                             "stride1")})
    weights = torch.softmax(-d, -1).contiguous()
    inds = torch.stack([dt, dh, dw], -1).contiguous()
    outs, grads = [], []
    for fn in (agg_cuda.nl_gather_stack, agg_cuda.nl_gather_stack_plain):
        args = [x.clone().requires_grad_() for x in (v1, weights, inds)]
        out = fn(*args, ps=3, stride0=1)
        g = torch.autograd.grad(out.pow(2).sum(), args)
        outs.append(out)
        grads.append(g)
    assert_close(outs[0], outs[1], "stack")
    for a, b in zip(*grads):
        assert_grad_close(a, b)


@pytest.mark.parametrize("search_impl,agg_impl", [("auto", "auto"),
                                                   ("lattice", "jnp")])
def test_impl_knob_keeps_the_modules_on_the_kernels(dev, search_impl,
                                                    agg_impl):
    from stnls_tpu_torch.agg import NonLocalGather
    from stnls_tpu_torch.search import NonLocalSearch
    v0, v1, flows = _inputs(dev)
    search = NonLocalSearch(5, 1, 3, 6, nheads=HD, stride1=0.5,
                            self_action="anchor", impl=search_impl)
    gather = NonLocalGather(ps=3, stride0=1, impl=agg_impl)
    n_s, n_g = nls_cuda.nls_topk.launches, agg_cuda.nl_gather_stack.launches
    d, inds = search(v0, v1, flows)
    gather(v1, torch.softmax(-d, -1), inds)
    assert nls_cuda.nls_topk.launches == n_s + 1
    assert agg_cuda.nl_gather_stack.launches == n_g + 1


def _off_integer(x, eps=1e-3):
    """Positions away from the bilinear kinks at integer coordinates."""
    frac = x - torch.floor(x)
    return (frac > eps) & (frac < 1 - eps)


@pytest.mark.parametrize("anchor,itype", [(True, "float"), (False, "float"),
                                          (True, "int")])
def test_search_backward_kernel_matches_plain(dev, anchor, itype):
    v0, v1, flows = _inputs(dev)
    stride1 = 0.5 if itype == "float" else 1
    kw = dict(KW, anchor=anchor, itype=itype, stride1=stride1)
    _, cells = nls_cuda.nls_topk(v0, v1, flows, **kw)
    geo = cells_geometry(flows, cells, H=H, W=W, ws=5, wt=1, stride0=1,
                         stride1=stride1, itype=itype)
    cfg = dict(ps=3, stride0=1, dist_type="l2", dilation=1, use_adj=False,
               itype=itype)
    g_d = torch.randn(cells.shape, device=dev,
                      generator=torch.Generator(dev).manual_seed(0))
    args = (v0, v1, geo["prop_h"], geo["prop_w"], geo["tj_k"], geo["valid"],
            g_d, cfg)
    n0 = nls_cuda.nls_topk_bwd.launches
    g_k = nls_cuda.nls_topk_bwd(*args)
    torch.cuda.synchronize()
    assert nls_cuda.nls_topk_bwd.launches == n0 + 1
    g_p = nls_cuda.nls_topk_bwd_plain(*args)
    assert_grad_close(g_k[0], g_p[0], "g_vid0")
    assert_grad_close(g_k[1], g_p[1], "g_vid1")
    # position gradients jump at integer coordinates: compare away from them
    off = _off_integer(geo["prop_h"]) & _off_integer(geo["prop_w"])
    for a, b, name in zip(g_k[2:], g_p[2:], ("g_prop_h", "g_prop_w")):
        if itype == "int":
            assert not a.any() and not b.any()
        else:
            assert_grad_close(a[off], b[off], name)


@pytest.mark.parametrize("itype,extra", [("float", {}), ("float",
                                                         {"stride0": 2}),
                                         ("int", {}),
                                         ("float", {"pt": 2, "use_adj": True})])
def test_gather_backward_kernel_matches_plain(dev, itype, extra):
    cfg = dict(dict(ps=3, stride0=1, pt=1, dilation=1, reflect_bounds=True,
                    use_adj=False, itype=itype), **extra)
    nH, nW = (H - 1) // cfg["stride0"] + 1, (W - 1) // cfg["stride0"] + 1
    rng = np.random.default_rng(2)

    def t(x):
        return torch.from_numpy(np.asarray(x, np.float32)).to(dev)

    K = 6
    vid = t(rng.standard_normal((B, HD, T, F, H, W)))
    weights = t(rng.random((B, HD, T, nH, nW, K)))
    flows = np.stack([rng.integers(-1, 2, (B, HD, T, nH, nW, K)),
                      3 * rng.standard_normal((B, HD, T, nH, nW, K)),
                      3 * rng.standard_normal((B, HD, T, nH, nW, K))], -1)
    flows = t(np.round(flows) if itype == "int" else flows)
    g = t(rng.standard_normal((B, HD, K, T, F, H, W)))
    n0 = agg_cuda.nl_gather_stack_bwd.launches
    g_k = agg_cuda.nl_gather_stack_bwd(vid, weights, flows, g, cfg,
                                       (True, True, True))
    torch.cuda.synchronize()
    assert agg_cuda.nl_gather_stack_bwd.launches == n0 + 1
    g_p = agg_cuda._gather_bwd_plain(vid, weights, flows, g, cfg,
                                     (True, True, True))
    assert_grad_close(g_k[0], g_p[0], "g_vid")
    assert_grad_close(g_k[1], g_p[1], "g_weights")
    if itype == "int":
        assert not g_k[2].any() and not g_p[2].any()
    else:
        off = _off_integer(flows[..., 1]) & _off_integer(flows[..., 2])
        assert_grad_close(g_k[2][off], g_p[2][off], "g_flows")


def test_one_backward_launches_each_backward_kernel_once(dev):
    from stnls_tpu_torch.agg import NonLocalGather
    from stnls_tpu_torch.search import NonLocalSearch
    v0, v1, flows = (x.requires_grad_() for x in _inputs(dev))
    search = NonLocalSearch(5, 1, 3, 6, nheads=HD, stride1=0.5,
                            self_action="anchor")
    gather = NonLocalGather(ps=3, stride0=1)
    counts = (nls_cuda.nls_topk_bwd.launches,
              agg_cuda.nl_gather_stack_bwd.launches,
              nls_cuda.nls_topk_bwd_plain.calls,
              agg_cuda._gather_bwd_plain.calls)
    d, inds = search(v0, v1, flows)
    gather(v1, torch.softmax(-d, -1), inds).pow(2).mean().backward()
    torch.cuda.synchronize()
    assert (nls_cuda.nls_topk_bwd.launches,
            agg_cuda.nl_gather_stack_bwd.launches,
            nls_cuda.nls_topk_bwd_plain.calls,
            agg_cuda._gather_bwd_plain.calls) == (counts[0] + 1,
                                                  counts[1] + 1,
                                                  counts[2], counts[3])
    assert float(flows.grad.abs().max()) > 0


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    v0, v1, flows = _inputs(dev)
    # more ranked slots than B1 keeps (75 cells, k = 70 anchored: 69)
    with pytest.raises(NotImplementedError):
        nls_cuda.nls_topk(v0, v1, flows, **dict(KW, k=70))
    with pytest.raises(ValueError):
        nls_cuda.nls_topk(v0, v1, flows, **dict(KW, ps=0))
    with pytest.raises(TypeError):
        nls_cuda.nls_topk(v0.double(), v1, flows, **KW)
    with pytest.raises(ValueError):
        nls_cuda.nls_topk(v0.transpose(-1, -2), v1, flows, **KW)
    w = torch.ones((B, HD, T, H, W, 2), device=dev)
    f = torch.zeros((B, HD, T, H, W, 2, 3), device=dev)
    with pytest.raises(NotImplementedError):
        agg_cuda.nl_gather_stack(v1, w, f, ps=3, stride0=1,
                                 reflect_bounds=False)
    with pytest.raises(ValueError):
        agg_cuda.nl_gather_stack(v1, w[..., :1], f, ps=3, stride0=1)


VOL_KW = dict(ws=5, wt=1, ps=3, stride0=1)


def _volume_inputs(dev, itype, seed=3):
    from stnls_tpu_torch.ops.nls import search_centres
    v0, v1, flows = _inputs(dev, seed)
    ctr_h, ctr_w = search_centres(v0.shape, flows, wt=1, stride0=1,
                                  itype=itype)
    return v0, v1, flows, ctr_h.contiguous(), ctr_w.contiguous()


@pytest.mark.parametrize("itype,dist_type", [("float", "l2"), ("int", "l2"),
                                             ("float", "prod")])
def test_volume_kernel_matches_plain(dev, itype, dist_type):
    v0, v1, _, ctr_h, ctr_w = _volume_inputs(dev, itype)
    kw = dict(VOL_KW, stride1=0.5 if itype == "float" else 1,
              dist_type=dist_type, itype=itype)
    n0 = nls_vol_cuda.nls_volume.launches
    d = nls_vol_cuda.nls_volume(v0, v1, ctr_h, ctr_w, **kw)
    torch.cuda.synchronize()
    assert nls_vol_cuda.nls_volume.launches == n0 + 1
    d_p = nls_vol_cuda.nls_volume_plain(v0, v1, ctr_h, ctr_w, **kw)
    assert torch.equal(d.isinf(), d_p.isinf())
    assert_close(d, d_p, "volume")


def _lattice_off_integer(flows, itype, stride1):
    """Per (query, slot): every lattice position of both axes away from
    the integer kinks of the bilinear read (where the centre gradients
    jump)."""
    from stnls_tpu_torch.ops.nls_k import search_aux
    aux = search_aux((B, HD, T, F, H, W), flows, ws=5, wt=1, stride0=1,
                     stride1=stride1, itype=itype)
    return (_off_integer(aux["dh"]).all(4), _off_integer(aux["dw"]).all(4))


@pytest.mark.parametrize("itype,dist_type,cotangent", [
    ("float", "l2", "dense"), ("float", "l2", "each"), ("int", "l2", "each"),
    ("float", "prod", "dense")])
def test_volume_backward_kernel_matches_plain(dev, itype, dist_type,
                                              cotangent):
    from stnls_tpu_torch.ops.nls_k import search_aux, aux_to_inds3
    from stnls_tpu_torch.search.non_local_search import _self_action_topk
    v0, v1, flows, ctr_h, ctr_w = _volume_inputs(dev, itype)
    stride1 = 0.5 if itype == "float" else 1
    cfg = dict(VOL_KW, stride1=stride1, dist_type=dist_type, dilation=1,
               full_ws=True, use_adj=False, itype=itype)
    gen = torch.Generator(dev).manual_seed(1)
    if cotangent == "dense":
        d = nls_vol_cuda.nls_volume(v0, v1, ctr_h, ctr_w, **{
            k: cfg[k] for k in cfg if k != "dilation"})
        g_d = torch.randn(d.shape, device=dev, generator=gen)
    else:
        # the cotangent of the volume under anchor_each / topk each, k=2
        d = nls_vol_cuda.nls_volume(v0, v1, ctr_h, ctr_w, **{
            k: cfg[k] for k in cfg if k != "dilation"}).requires_grad_()
        aux = search_aux(v0.shape, flows, ws=5, wt=1, stride0=1,
                         stride1=stride1, itype=itype)
        ds, _ = _self_action_topk(d, aux_to_inds3(aux, d.shape),
                                  self_action="anchor_each",
                                  topk_mode="each", k=2, wt=1,
                                  dist_type=dist_type)
        g_d, = torch.autograd.grad(ds, d, torch.randn(
            ds.shape, device=dev, generator=gen))
        assert int((g_d != 0).sum()) == ds.numel()
    n0 = nls_vol_cuda.nls_volume_bwd.launches
    g_k = nls_vol_cuda.nls_volume_bwd(v0, v1, ctr_h, ctr_w, g_d, cfg)
    torch.cuda.synchronize()
    assert nls_vol_cuda.nls_volume_bwd.launches == n0 + 1
    g_p = nls_vol_cuda.nls_volume_bwd_plain(v0, v1, ctr_h, ctr_w, g_d, cfg)
    assert_grad_close(g_k[0], g_p[0], "g_vid0")
    assert_grad_close(g_k[1], g_p[1], "g_vid1")
    offs = _lattice_off_integer(flows, itype, stride1)
    for a, b, off, name in zip(g_k[2:], g_p[2:], offs,
                               ("g_ctr_h", "g_ctr_w")):
        if itype == "int":
            assert not a.any() and not b.any()
        else:
            assert_grad_close(a[off], b[off], name)


def test_volume_search_launches_its_kernels(dev):
    from stnls_tpu_torch.search import NonLocalSearch
    v0, v1, flows = (x.requires_grad_() for x in _inputs(dev))
    search = NonLocalSearch(5, 1, 3, 2, nheads=HD, stride1=0.5,
                            self_action="anchor_each", topk_mode="each")
    counts = (nls_vol_cuda.nls_volume.launches,
              nls_vol_cuda.nls_volume_bwd.launches,
              nls_vol_cuda.nls_volume_bwd_plain.calls,
              nls_cuda.nls_topk.launches)
    d, inds = search(v0, v1, flows)
    assert d.shape == (B, HD, T, H, W, 3 * 2)
    (torch.softmax(-d, -1) * inds[..., 1]).sum().backward()
    torch.cuda.synchronize()
    assert (nls_vol_cuda.nls_volume.launches,
            nls_vol_cuda.nls_volume_bwd.launches,
            nls_vol_cuda.nls_volume_bwd_plain.calls,
            nls_cuda.nls_topk.launches) == (counts[0] + 1, counts[1] + 1,
                                            counts[2], counts[3])
    assert float(flows.grad.abs().max()) > 0


# B1, B5 and B6 at (ps, F a head) beside the slice's: the run-time body,
# with a variant of the search for each
ANY_PS_CASES = [
    (1, 2, {}), (1, 4, dict(itype="int", dilation=2)),
    (1, 16, dict(dist_type="prod", stride0=2)), (1, 32, dict(use_adj=True)),
    (7, 2, dict(dilation=2)), (7, 4, dict(itype="int", use_adj=True)),
    (7, 16, dict(stride0=2, stride1=0.5)), (7, 32, dict(dist_type="prod"))]


def _any_ps_inputs(dev, F, stride0, seed=5):
    from stnls_tpu_torch.nn.flow import search_flow
    rng = np.random.default_rng(seed)

    def t(x):
        return torch.from_numpy(x.astype(np.float32)).to(dev)

    ff, bf = (t(1.5 * rng.standard_normal((B, T, 2, H, W))) for _ in "fb")
    return (t(rng.standard_normal((B, 1, T, F, H, W))),
            t(rng.standard_normal((B, 1, T, F, H, W))),
            search_flow(ff, bf, 1, stride0)[:, None].contiguous())


@pytest.mark.parametrize("ps,F,extra", ANY_PS_CASES)
def test_search_kernels_take_any_patch_size_and_width(dev, ps, F, extra):
    """B1's and B5's dists equal the plain volume's bitwise (the same sums
    in the same order); B6 agrees with the VJP of the plain volume."""
    from stnls_tpu_torch.ops.nls import search_centres
    c = dict(dict(ws=5, wt=1, ps=ps, stride0=1, stride1=1, dist_type="l2",
                  dilation=1, use_adj=False, itype="float"), **extra)
    v0, v1, flows = _any_ps_inputs(dev, F, c["stride0"])
    n0 = nls_cuda.nls_topk.launches
    d, cells = nls_cuda.nls_topk(v0, v1, flows, k=10, anchor=True, **c)
    torch.cuda.synchronize()
    assert nls_cuda.nls_topk.launches == n0 + 1
    d_p, cells_p = nls_cuda.nls_topk_plain(v0, v1, flows, k=10, anchor=True,
                                           **c)
    assert torch.equal(d, d_p) and torch.equal(cells, cells_p)
    ctr_h, ctr_w = (x.contiguous() for x in search_centres(
        v0.shape, flows, wt=1, stride0=c["stride0"], itype=c["itype"]))
    vol = nls_vol_cuda.nls_volume(v0, v1, ctr_h, ctr_w, **c)
    assert torch.equal(vol, nls_vol_cuda.nls_volume_plain(v0, v1, ctr_h,
                                                          ctr_w, **c))
    g_d = torch.randn(vol.shape, device=dev,
                      generator=torch.Generator(dev).manual_seed(2))
    g_d[~vol.isfinite()] = 0.
    cfg = dict(c, full_ws=True)
    g_k = nls_vol_cuda.nls_volume_bwd(v0, v1, ctr_h, ctr_w, g_d, cfg)
    torch.cuda.synchronize()
    g_p = nls_vol_cuda.nls_volume_bwd_plain(v0, v1, ctr_h, ctr_w, g_d, cfg)
    assert_grad_close(g_k[0], g_p[0], "g_vid0")
    assert_grad_close(g_k[1], g_p[1], "g_vid1")


@pytest.mark.parametrize("ps,F", [(1, 2), (1, 4), (1, 16), (5, 8), (7, 32)])
def test_search_module_runs_at_any_patch_size_and_width(dev, ps, F):
    """NonLocalSearch through B1 on the card equals its run on CPU copies
    (the plain versions), forward and video gradients."""
    from stnls_tpu_torch.search import NonLocalSearch
    search = NonLocalSearch(5, 1, ps, 6, self_action="anchor")
    outs = []
    for device in (dev, torch.device("cpu")):
        v0, v1, flows = (x.to(device) for x in _any_ps_inputs(dev, F, 1))
        v0.requires_grad_()
        n0 = nls_cuda.nls_topk.launches
        d, inds = search(v0, v1, flows)
        g, = torch.autograd.grad((d * d).mean(), v0)
        assert nls_cuda.nls_topk.launches == n0 + (device == dev)
        outs.append((d, inds, g))
    (d, inds, g), (d_p, inds_p, g_p) = outs
    assert d.shape == (B, 1, T, H, W, 6)
    assert_close(d, d_p, "dists")
    assert_close(inds, inds_p, "inds")
    assert_grad_close(g, g_p, "g_vid0")


@pytest.mark.parametrize("k,anchor", [(65, True), (64, False)])
def test_search_kernel_keeps_64_ranked_slots(dev, k, anchor):
    v0, v1, flows = _inputs(dev)
    kw = dict(KW, k=k, anchor=anchor)
    d, cells = nls_cuda.nls_topk(v0, v1, flows, **kw)
    d_p, cells_p = nls_cuda.nls_topk_plain(v0, v1, flows, **kw)
    assert d.shape[-1] == k
    assert torch.equal(d, d_p) and torch.equal(cells, cells_p)


def test_more_ranked_slots_take_the_volume_route(dev):
    from stnls_tpu_torch.search import NonLocalSearch
    v0, v1, flows = _inputs(dev)
    search = NonLocalSearch(5, 1, 3, 70, nheads=HD, stride1=0.5,
                            self_action="anchor")
    counts = (nls_cuda.nls_topk.launches, nls_vol_cuda.nls_volume.launches)
    d, _ = search(v0, v1, flows)
    torch.cuda.synchronize()
    assert (nls_cuda.nls_topk.launches,
            nls_vol_cuda.nls_volume.launches) == (counts[0], counts[1] + 1)
    d_p, _ = nls_cuda.nls_topk_plain(v0, v1, flows, **dict(KW, k=70))
    assert_close(d, d_p, "dists")


def test_int_search_feeds_the_aggregators(dev):
    """An int search's offsets are int32: each aggregator takes them (the
    kernels read float offsets) and launches its kernel."""
    from stnls_tpu_torch.agg import NonLocalGather, NonLocalGatherAdd, \
        NonLocalScatterAdd, PooledPatchSum
    from stnls_tpu_torch.search import NonLocalSearch
    v0, v1, flows = _inputs(dev)
    d, inds = NonLocalSearch(5, 1, 1, 4, nheads=HD, self_action="anchor",
                             itype="int")(v0, v1, flows)
    assert inds.dtype == torch.int32
    w = torch.softmax(-d, -1)
    for agg, kernel in ((NonLocalGather(ps=1, stride0=1, itype="int"),
                         agg_cuda.nl_gather_stack),
                        (NonLocalGatherAdd(ps=1, strideIn=1, strideOut=1,
                                           itype="int"),
                         agg_cuda.nl_gather_stack),
                        (NonLocalScatterAdd(ps=1, strideIn=1, strideOut=1),
                         agg_sp_cuda.nl_scatter_add),
                        (PooledPatchSum(ps=1, stride0=1),
                         agg_sp_cuda.nl_pool)):
        n0 = kernel.launches
        out = agg(v1, w, inds)
        torch.cuda.synchronize()
        assert kernel.launches == n0 + 1 and bool(out.isfinite().all())


def _sp_inputs(dev, stride, seed=4, K=6):
    """Video, weights (negative ones and ones below 1e-8 included) and
    offsets with exact half-integers and -1e8 fills, on the stride grid."""
    rng = np.random.default_rng(seed)
    nH, nW = (H - 1) // stride + 1, (W - 1) // stride + 1

    def t(x):
        return torch.from_numpy(np.asarray(x, np.float32)).to(dev)

    weights = rng.random((B, HD, T, nH, nW, K))
    weights[..., 0], weights[..., 1] = -0.25, 5e-9
    flows = np.stack([rng.integers(-1, 2, (B, HD, T, nH, nW, K)),
                      3 * rng.standard_normal((B, HD, T, nH, nW, K)),
                      3 * rng.standard_normal((B, HD, T, nH, nW, K))], -1)
    flows[..., 2, 1:] = (0.5, -1.5)
    flows[..., 3, 1:] = (1.5, -0.5)
    flows[:, :, 1, ::3, 1::2, 5, :] = -1e8
    return (t(rng.standard_normal((B, HD, T, F, H, W))), t(weights),
            t(flows))


SP_CASES = [dict(), dict(stride=2, dilation=2, use_adj=True, ps=4, pt=2),
            dict(reflect_bounds=False)]
# ScatterAdd also takes strideIn != strideOut and an explicit output size
SCATTER_CASES = SP_CASES + [dict(stride=2, strideOut=1),
                            dict(strideOut=2, outH=24, outW=40)]


def _check_sp_backward(bwd, plain_bwd, args, cfg):
    n0 = bwd.launches
    g_k = bwd(*args, cfg, (True, True, True))
    torch.cuda.synchronize()
    assert bwd.launches == n0 + 1
    g_p = plain_bwd(*args, cfg, (True, True, True))
    for a, b, name in zip(g_k, g_p, ("g_vid", "g_weights")):
        assert float(b.abs().max()) > 0
        assert_grad_close(a, b, name)
    assert not g_k[2].any() and not g_p[2].any()


@pytest.mark.parametrize("extra", SCATTER_CASES)
def test_scatter_add_kernels_match_plain(dev, extra):
    s = extra.get("stride", 1)
    cfg = dict(ps=extra.get("ps", 3), strideIn=s,
               strideOut=extra.get("strideOut", s), pt=extra.get("pt", 1),
               dilation=extra.get("dilation", 1),
               reflect_bounds=extra.get("reflect_bounds", True),
               use_adj=extra.get("use_adj", False),
               outH=extra.get("outH", 0), outW=extra.get("outW", 0))
    vid, weights, flows = _sp_inputs(dev, s)
    n0 = agg_sp_cuda.nl_scatter_add.launches
    out = agg_sp_cuda.nl_scatter_add(vid, weights, flows, **cfg)
    torch.cuda.synchronize()
    assert agg_sp_cuda.nl_scatter_add.launches == n0 + 1
    assert_close(out, agg_sp_cuda.nl_scatter_add_plain(vid, weights, flows,
                                                       **cfg), "out")
    g = torch.randn(out.shape, device=dev,
                    generator=torch.Generator(dev).manual_seed(0))
    _check_sp_backward(agg_sp_cuda.nl_scatter_add_bwd,
                       agg_sp_cuda._scatter_add_bwd_plain,
                       (vid, weights, flows, g),
                       dict(cfg, outH=out.shape[-2], outW=out.shape[-1]))


@pytest.mark.parametrize("extra", SP_CASES)
def test_pool_kernels_match_plain(dev, extra):
    s = extra.get("stride", 1)
    cfg = dict(ps=extra.get("ps", 3), stride0=s, pt=extra.get("pt", 1),
               dilation=extra.get("dilation", 1),
               reflect_bounds=extra.get("reflect_bounds", True),
               use_adj=extra.get("use_adj", False))
    vid, weights, flows = _sp_inputs(dev, s)
    n0 = agg_sp_cuda.nl_pool.launches
    out = agg_sp_cuda.nl_pool(vid, weights, flows, **cfg)
    torch.cuda.synchronize()
    assert agg_sp_cuda.nl_pool.launches == n0 + 1
    assert_close(out, agg_sp_cuda.nl_pool_plain(vid, weights, flows, **cfg),
                 "out")
    g = torch.randn(out.shape, device=dev,
                    generator=torch.Generator(dev).manual_seed(0))
    _check_sp_backward(agg_sp_cuda.nl_pool_bwd, agg_sp_cuda._pool_bwd_plain,
                       (vid, weights, flows, g), cfg)


def test_agg_example_runs_through_its_kernels(dev):
    """The twin of examples/agg_example.py at 32^2: B1, B3/B4 (Gather,
    GatherAdd), B7/B8 and B9/B10 each launched, no plain backward called,
    and no gradient to the rounded offsets of ScatterAdd and Pool."""
    from stnls_tpu_torch import agg_example
    cfg = dict(agg_example.CONFIG, H=32, W=32)
    kernels = (nls_cuda.nls_topk, agg_cuda.nl_gather_stack,
               agg_cuda.nl_gather_stack_bwd, agg_sp_cuda.nl_scatter_add,
               agg_sp_cuda.nl_scatter_add_bwd, agg_sp_cuda.nl_pool,
               agg_sp_cuda.nl_pool_bwd)
    plains = (agg_cuda._gather_bwd_plain, agg_sp_cuda._scatter_add_bwd_plain,
              agg_sp_cuda._pool_bwd_plain)
    before = [k.launches for k in kernels], [p.calls for p in plains]
    *_, res = agg_example.run(*agg_example.make_inputs(0, device=dev, **cfg),
                              cfg)
    torch.cuda.synchronize()
    assert all(k.launches > n for k, n in zip(kernels, before[0]))
    assert [p.calls for p in plains] == before[1]
    for name in ("scatter_add", "pool"):
        assert not res[name][3].any()
    assert all(float(res[name][2].abs().max()) > 0 for name in res)


def test_sp_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    vid, weights, flows = _sp_inputs(dev, 1)
    with pytest.raises(TypeError):
        agg_sp_cuda.nl_pool(vid.double(), weights, flows, ps=3, stride0=1)
    with pytest.raises(ValueError):
        agg_sp_cuda.nl_scatter_add(vid, weights[..., :2], flows, ps=3,
                                   strideIn=1, strideOut=1)
    with pytest.raises(ValueError):
        agg_sp_cuda.nl_pool(vid, weights, flows, ps=3, stride0=1,
                            dilation=1.5)


# -- temporal-chunk mode (time sharding): B1, B2, B5, B6 --
CHUNK = dict(T=8, T_local=4, wt=2, halo=4)


def _chunk_inputs(dev, seed=11, F=8, H=32):
    """A whole sequence of CHUNK["T"] frames and its search flows."""
    from stnls_tpu_torch.nn.flow import search_flow
    rng = np.random.default_rng(seed)

    def t(x):
        return torch.from_numpy(x.astype(np.float32)).to(dev)

    shape = (1, 2, CHUNK["T"], F, H, H)
    v0, v1 = t(rng.standard_normal(shape)), t(rng.standard_normal(shape))
    fflow, bflow = (t(1.5 * rng.standard_normal((1, CHUNK["T"], 2, H, H)))
                    for _ in range(2))
    flows = search_flow(fflow, bflow, CHUNK["wt"], 1)[:, None].contiguous()
    return v0, v1, flows


def _chunk(x, t0, halo=CHUNK["halo"], frames=CHUNK["T_local"]):
    return halo_chunk(x, t0, frames, halo)


@pytest.mark.parametrize("itype", ["float", "int"])
@pytest.mark.parametrize("t0", [0, CHUNK["T_local"]])
@pytest.mark.parametrize("compiled", [True, False])
def test_chunk_kernels_match_plain(dev, itype, t0, compiled):
    """B1 and B5 in chunk mode bitwise equal to their plain chunk
    versions, in the compiled (3, 8) and the run-time body; B2 and B6 at
    1e-4 * max|ref| on seeded cotangents."""
    from stnls_tpu_torch.ops.nls import search_centres
    from stnls_tpu_torch.ops.nls_k import cells_geometry
    v0, v1, flows = _chunk_inputs(dev)
    Tl, T = CHUNK["T_local"], CHUNK["T"]
    v0p, v1p = _chunk(v0, t0), _chunk(v1, t0)
    fl = flows[:, :, t0:t0 + Tl].contiguous()
    stride1 = 0.5 if itype == "float" else 1
    kw = dict(ws=5, wt=CHUNK["wt"], ps=3, stride0=1, stride1=stride1,
              itype=itype, query_t0=t0, T_global=T)
    saved = nls_cuda.COMPILED_BODY, nls_vol_cuda.COMPILED_BODY
    nls_cuda.COMPILED_BODY = nls_vol_cuda.COMPILED_BODY = compiled
    try:
        d, c = nls_cuda.nls_topk(v0p, v1p, fl, k=10, anchor=True, **kw)
        ctr = [x.contiguous() for x in search_centres(
            v0p.shape, fl, wt=CHUNK["wt"], stride0=1, itype=itype,
            T_global=T)]
        vol = nls_vol_cuda.nls_volume(v0p, v1p, *ctr, **kw)
    finally:
        nls_cuda.COMPILED_BODY, nls_vol_cuda.COMPILED_BODY = saved
    d_p, c_p = nls_cuda.nls_topk_plain(v0p, v1p, fl, k=10, anchor=True, **kw)
    assert d.shape == (1, 2, Tl, 32, 32, 10)
    assert torch.equal(d, d_p) and torch.equal(c, c_p)
    assert torch.equal(vol, nls_vol_cuda.nls_volume_plain(v0p, v1p, *ctr,
                                                          **kw))
    gen = torch.Generator(dev).manual_seed(2)
    cfg = dict(kw, dist_type="l2", dilation=1, full_ws=True, use_adj=False)
    g_vol = torch.randn(vol.shape, device=dev, generator=gen)
    g_k = nls_vol_cuda.nls_volume_bwd(v0p, v1p, *ctr, g_vol, cfg)
    g_p = nls_vol_cuda.nls_volume_bwd_plain(v0p, v1p, *ctr, g_vol, cfg)
    for a, b, name in zip(g_k[:2], g_p[:2], ("B6 g_vid0", "B6 g_vid1")):
        assert_grad_close(a, b, name)
    geo = cells_geometry(fl, c, H=32, W=32, ws=5, wt=CHUNK["wt"], stride0=1,
                         stride1=stride1, itype=itype, query_t0=t0,
                         T_global=T, halo=CHUNK["halo"])
    pos = (geo["prop_h"], geo["prop_w"], geo["tj_k"], geo["valid"])
    g_d = torch.randn(d.shape, device=dev, generator=gen)
    bcfg = dict(ps=3, stride0=1, dist_type="l2", dilation=1, use_adj=False,
                itype=itype)
    g_k = nls_cuda.nls_topk_bwd(v0p, v1p, *pos, g_d, bcfg, t0, T)
    g_p = nls_cuda.nls_topk_bwd_plain(v0p, v1p, *pos, g_d, bcfg, t0, T)
    for a, b, name in zip(g_k[:2], g_p[:2], ("B2 g_vid0", "B2 g_vid1")):
        assert_grad_close(a, b, name)
    # the halo frames a window never reads carry no gradient
    assert not g_k[0][:, :, :CHUNK["halo"]].any()


def test_chunks_equal_the_whole_video_on_the_kernels(dev):
    """B1's and B5's chunks, joined over the sequence, equal the whole
    video's outputs bitwise."""
    from stnls_tpu_torch.ops.nls import search_centres
    v0, v1, flows = _chunk_inputs(dev, seed=12)
    Tl, T = CHUNK["T_local"], CHUNK["T"]
    kw = dict(ws=5, wt=CHUNK["wt"], ps=3, stride0=1, stride1=0.5)
    d_all, c_all = nls_cuda.nls_topk(v0, v1, flows, k=10, anchor=True, **kw)
    ctr = [x.contiguous() for x in search_centres(v0.shape, flows,
                                                  wt=CHUNK["wt"], stride0=1)]
    vol_all = nls_vol_cuda.nls_volume(v0, v1, *ctr, **kw)
    for t0 in range(0, T, Tl):
        v0p, v1p = _chunk(v0, t0), _chunk(v1, t0)
        ck = dict(kw, query_t0=t0, T_global=T)
        d, c = nls_cuda.nls_topk(v0p, v1p,
                                 flows[:, :, t0:t0 + Tl].contiguous(), k=10,
                                 anchor=True, **ck)
        vol = nls_vol_cuda.nls_volume(
            v0p, v1p, *(x[:, :, t0:t0 + Tl].contiguous() for x in ctr), **ck)
        sl = slice(t0, t0 + Tl)
        assert torch.equal(d, d_all[:, :, sl])
        assert torch.equal(c, c_all[:, :, sl])
        assert torch.equal(vol, vol_all[:, :, sl])


def test_chunk_wrappers_raise_on_a_short_halo(dev):
    v0, v1, flows = _chunk_inputs(dev)
    with pytest.raises(ValueError):
        nls_cuda.nls_topk(_chunk(v0, 0, halo=2), _chunk(v1, 0, halo=2),
                          flows[:, :, :4].contiguous(), ws=5, wt=2, ps=3,
                          stride0=1, stride1=1, k=4, anchor=True,
                          query_t0=0, T_global=8)


def test_time_sharded_search_on_a_world_of_one(dev):
    """time_sharded_search on a one-rank NCCL mesh equals the search of
    the whole video, forward and backward into both videos."""
    import torch.distributed as dist
    from stnls_tpu_torch.parallel import make_mesh, time_sharded_search
    from stnls_tpu_torch.search import NonLocalSearch
    v0, v1, flows = _chunk_inputs(dev, seed=13)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_mesh({"data": 1, "time": 1})
        outs = []
        for run in ("whole", "sharded"):
            a, b = v0.clone().requires_grad_(), v1.clone().requires_grad_()
            if run == "whole":
                d, i = NonLocalSearch(5, CHUNK["wt"], 3, 10, stride1=0.5,
                                      self_action="anchor")(a, b, flows)
            else:
                d, i = time_sharded_search(a, b, flows, mesh, ws=5,
                                           wt=CHUNK["wt"], ps=3, k=10,
                                           stride1=0.5, self_action="anchor")
            outs.append((d, i) + torch.autograd.grad(d.pow(2).sum(),
                                                     (a, b)))
    finally:
        dist.destroy_process_group()
    (d, i, g0, g1), (d_s, i_s, g0_s, g1_s) = outs
    assert torch.equal(d, d_s) and torch.equal(i, i_s)
    assert_grad_close(g0_s, g0, "g_vid0")
    assert_grad_close(g1_s, g1, "g_vid1")
