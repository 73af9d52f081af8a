"""The hand-written CUDA kernels against their plain versions, on the
card. Marked `cuda`: they skip where there is no NVIDIA GPU. This file
imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/torch_port/test_torch_cuda_kernels.py
"""

import math
import sys

import numpy as np
import pytest
import torch

from stnls_tpu_torch.ops import agg_cuda, agg_sp_cuda, nls_cuda, \
    nls_geometry_cuda, nls_vol_cuda
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


# B3's cases beyond the search's own weights and offsets (None): F a head,
# ps, and the modes; "intpos" puts every float offset on an integer (zero
# corner weights), "zero_w" zeroes a third of the weights
B3_CASES = [None, dict(F=1, ps=1), dict(F=2, ps=3), dict(F=3, ps=3),
            dict(F=16, ps=1), dict(F=32, ps=5), dict(F=12, ps=3, stride0=2),
            dict(F=8, ps=3, dilation=2), dict(F=8, ps=3, use_adj=True, pt=2),
            dict(F=8, ps=3, itype="int"), dict(F=8, ps=5, intpos=True),
            dict(F=5, ps=4, stride0=2, use_adj=True, zero_w=True)]


def _gather_case(dev, F, ps, stride0=1, dilation=1, use_adj=False, pt=1,
                 itype="float", intpos=False, zero_w=False, K=4, seed=6):
    """Seeded video, weights and offsets for B3 on 24^2 frames."""
    Hc = 24
    nH = (Hc - 1) // stride0 + 1
    rng = np.random.default_rng(seed)

    def t(x):
        return torch.from_numpy(np.asarray(x, np.float32)).to(dev)

    shape = (B, HD, T, nH, nH, K)
    vid = t(rng.standard_normal((B, HD, T, F, Hc, Hc)))
    w = rng.random(shape) * (rng.random(shape) > (0.3 if zero_w else 0))
    flows = np.stack([rng.integers(-1, 2, shape),
                      3 * rng.standard_normal(shape),
                      3 * rng.standard_normal(shape)], -1)
    if itype == "int" or intpos:
        flows = np.round(flows)
    cfg = dict(ps=ps, stride0=stride0, dilation=dilation, use_adj=use_adj,
               pt=pt, itype=itype)
    return vid, t(w), t(flows), cfg


@pytest.mark.parametrize("case", B3_CASES)
def test_gather_kernel_forward_and_backward(dev, case, monkeypatch):
    if case is None:
        v0, v1, flows = _inputs(dev, 1)
        d, cells = nls_cuda.nls_topk(v0, v1, flows, **KW)
        d, (dt, dh, dw) = nls_dists_at_cells(v0, v1, flows, cells,
                                             **{k: KW[k] for k in
                                                ("ws", "wt", "ps", "stride0",
                                                 "stride1")})
        vid = v1
        weights = torch.softmax(-d, -1).contiguous()
        inds = torch.stack([dt, dh, dw], -1).contiguous()
        cfg = dict(ps=3, stride0=1)
    else:
        vid, weights, inds, cfg = _gather_case(dev, **case)
    def run(fn):
        args = [x.clone().requires_grad_(x is not inds or
                                         cfg.get("itype") != "int")
                for x in (vid, weights, inds)]
        out = fn(*args, **cfg)
        wanted = [x for x in args if x.requires_grad]
        return out, torch.autograd.grad(out.pow(2).sum(), wanted)

    ref, g_ref = run(agg_cuda.nl_gather_stack_plain)
    # the kernel on a channels-last copy of the video and on the planar
    # video (the wrapper picks by the stack's size)
    for cl_min in (0, sys.maxsize):
        monkeypatch.setattr(agg_cuda, "CHANNELS_LAST_MIN", cl_min)
        n0 = agg_cuda.nl_gather_stack.launches
        out, grads = run(agg_cuda.nl_gather_stack)
        assert agg_cuda.nl_gather_stack.launches == n0 + 1
        assert_close(out, ref, "stack")
        assert_grad_close(out, ref, "stack")
        if case is None:
            for a, b in zip(grads, g_ref):
                assert_grad_close(a, b)
            continue
        assert_grad_close(grads[0], g_ref[0], "g_vid")
        assert_grad_close(grads[1], g_ref[1], "g_weights")
        if len(grads) == 3 and not case.get("intpos"):
            off = _off_integer(inds[..., 1]) & _off_integer(inds[..., 2])
            assert_grad_close(grads[2][..., 1:][off],
                              g_ref[2][..., 1:][off], "g_flows")


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


# B2's cases beyond the search's own cells (anchor given): F a head (also
# not a multiple of the vector width), ps, the modes, chunk mode with
# t0 > 0 (halo frames of g_vid0 exactly 0), and on every case zero
# cotangents and invalid cells (tj = -1); "intpos" puts every position on
# integer coordinates (zero corner weights)
B2_CASES = [(True, "float", None), (False, "float", None), (True, "int", None)]
B2_CASES += [(None, "float", c) for c in (
    dict(F=1, ps=1), dict(F=2, ps=1), dict(F=3, ps=3), dict(F=8, ps=3),
    dict(F=16, ps=1), dict(F=32, ps=5), dict(F=5, ps=3, stride0=2),
    dict(F=8, ps=3, dilation=2), dict(F=8, ps=3, use_adj=True),
    dict(F=8, ps=3, dist_type="prod"), dict(F=2, ps=1, stride0=2),
    dict(F=12, ps=3, T_v=6, T_q=2, t0=3), dict(F=2, ps=1, T_v=6, T_q=2, t0=3),
    dict(F=8, ps=3, intpos=True), dict(F=200, ps=1, H=8, K=2))]
B2_CASES += [(None, "int", dict(F=8, ps=3)), (None, "int", dict(F=2, ps=1))]


def _b2_case(dev, itype, F, ps, stride0=1, dilation=1, use_adj=False,
             dist_type="l2", T_v=T, T_q=None, t0=None, intpos=False, H=20,
             K=5, seed=7):
    """B2's arguments on seeded positions around each query, target
    frames with a share of -1 (invalid) and a cotangent with a share of
    zeros, on H x H frames of T_v video frames (chunk mode: T_q query
    frames at global t0 with halos of (T_v - T_q) / 2)."""
    rng = np.random.default_rng(seed)
    T_q = T_v if T_q is None else T_q
    nH = (H - 1) // stride0 + 1
    shape = (B, HD, T_q, nH, nH, K)

    def t(x):
        return torch.from_numpy(np.asarray(x, np.float32)).to(dev)

    q = np.arange(nH) * stride0
    ph = q[:, None, None] + 3 * rng.standard_normal(shape)
    pw = q[None, :, None] + 3 * rng.standard_normal(shape)
    if itype == "int" or intpos:
        ph, pw = np.round(ph), np.round(pw)
    ph, pw = np.clip(ph, -2, H + 1), np.clip(pw, -2, H + 1)
    tj = rng.integers(-1, T_v, shape)
    g_d = rng.standard_normal(shape) * (rng.random(shape) > 0.3)
    cfg = dict(ps=ps, stride0=stride0, dist_type=dist_type,
               dilation=dilation, use_adj=use_adj, itype=itype)
    chunk = () if T_q == T_v else (t0, t0 + T_q + 3)
    return (t(rng.standard_normal((B, HD, T_v, F, H, H))),
            t(rng.standard_normal((B, HD, T_v, F, H, H))), t(ph), t(pw),
            torch.from_numpy(np.maximum(tj, 0)).to(dev),
            torch.from_numpy(tj >= 0).to(dev), t(g_d), cfg) + chunk


@pytest.mark.parametrize("anchor,itype,case", B2_CASES)
def test_search_backward_kernel_matches_plain(dev, anchor, itype, case):
    if case is None:
        v0, v1, flows = _inputs(dev)
        stride1 = 0.5 if itype == "float" else 1
        kw = dict(KW, anchor=anchor, itype=itype, stride1=stride1)
        _, cells = nls_cuda.nls_topk(v0, v1, flows, **kw)
        geo = cells_geometry(flows, cells, H=H, W=W, ws=5, wt=1, stride0=1,
                             stride1=stride1, itype=itype)
        cfg = dict(ps=3, stride0=1, dist_type="l2", dilation=1,
                   use_adj=False, itype=itype)
        g_d = torch.randn(cells.shape, device=dev,
                          generator=torch.Generator(dev).manual_seed(0))
        args = (v0, v1, geo["prop_h"], geo["prop_w"], geo["tj_k"],
                geo["valid"], g_d, cfg)
    else:
        args = _b2_case(dev, itype, **case)
    n0 = nls_cuda.nls_topk_bwd.launches
    stats = torch.zeros(4, dtype=torch.int64, device=dev)
    g_k = nls_cuda.nls_topk_bwd(*args, stats=stats)
    torch.cuda.synchronize()
    assert nls_cuda.nls_topk_bwd.launches == n0 + 1
    g_p = nls_cuda.nls_topk_bwd_plain(*args)
    assert_grad_close(g_k[0], g_p[0], "g_vid0")
    assert_grad_close(g_k[1], g_p[1], "g_vid1")
    # the kernel counts the active (q, k) pairs
    assert int(stats[3]) == int((args[5] & (args[6] != 0)).sum())
    if case is not None and "t0" in case:
        halo = (args[0].shape[2] - case["T_q"]) // 2
        assert not g_k[0][:, :, :halo].any()
        assert not g_k[0][:, :, halo + case["T_q"]:].any()
    # position gradients jump at integer coordinates: compare away from them
    off = _off_integer(args[2]) & _off_integer(args[3])
    for a, b, name in zip(g_k[2:], g_p[2:], ("g_prop_h", "g_prop_w")):
        if itype == "int":
            assert not a.any() and not b.any()
        elif case is None or not case.get("intpos"):
            assert_grad_close(a[off], b[off], name)


def test_search_backward_query_gradient_is_deterministic(dev):
    """At ps = 1 each pixel of g_vid0 belongs to one query: B2 stores it
    once, so two calls agree bitwise (g_vid1 sums atomics in any order)."""
    args = _b2_case(dev, "float", F=2, ps=1, H=64, K=10)
    first = nls_cuda.nls_topk_bwd(*args)[0]
    for _ in range(2):
        assert torch.equal(nls_cuda.nls_topk_bwd(*args)[0], first)


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


def _gather_bwd_case(dev, itype, cfg, F_head, offsets, seed=5, K=6, H=H,
                     W=W):
    """Video, weights, offsets and a cotangent for B4 on H x W frames:
    offsets of `offsets` std, or ones to centres drawn anywhere in the
    frame ("scatter": on large frames a tile's slots spread over boxes that
    do not fit the shared pool, the global path), or ones that push every
    patch over the frame's borders ("border": reflections)."""
    nH, nW = (H - 1) // cfg["stride0"] + 1, (W - 1) // cfg["stride0"] + 1
    rng = np.random.default_rng(seed)

    def t(x):
        return torch.from_numpy(np.asarray(x, np.float32)).to(dev)

    q_h = np.arange(nH)[:, None, None] * cfg["stride0"]
    q_w = np.arange(nW)[None, :, None] * cfg["stride0"]
    if offsets == "scatter":
        dh = rng.uniform(0, H - 1, (B, HD, T, nH, nW, K)) - q_h
        dw = rng.uniform(0, W - 1, (B, HD, T, nH, nW, K)) - q_w
    elif offsets == "border":
        dh = np.where(q_h < H / 2, -q_h - 2.3, H - q_h + 1.7)
        dw = np.where(q_w < W / 2, -q_w - 1.6, W - q_w + 2.4)
        dh = np.broadcast_to(dh, (B, HD, T, nH, nW, K))
        dw = np.broadcast_to(dw, (B, HD, T, nH, nW, K))
        dh = dh + 0.25 * rng.standard_normal(dh.shape)
        dw = dw + 0.25 * rng.standard_normal(dw.shape)
    else:
        dh = offsets * rng.standard_normal((B, HD, T, nH, nW, K))
        dw = offsets * rng.standard_normal((B, HD, T, nH, nW, K))
    flows = np.stack([rng.integers(-1, 2, (B, HD, T, nH, nW, K)), dh, dw], -1)
    flows = t(np.round(flows) if itype == "int" else flows)
    vid = t(rng.standard_normal((B, HD, T, F_head, H, W)))
    weights = rng.random((B, HD, T, nH, nW, K))
    weights[..., ::3] = 0.    # zero weights add nothing to g_vid
    g = t(rng.standard_normal((B, HD, K, T, F_head, H, W)))
    return vid, t(weights), flows, g


# (itype, cfg beside the defaults, F a head, offsets): "scatter" (on
# 128^2 frames, whose boxes outgrow the shared pool) forces the global
# path, "border" the reflections, F = 32 the channel groups
B4_CASES = [("float", {}, 8, "scatter"), ("float", {}, 8, "border"),
            ("int", {}, 8, "border"), ("int", {"pt": 2}, 8, 3.),
            ("float", {"pt": 2}, 8, 3.), ("float", {"dilation": 2}, 8, 3.),
            ("float", {"stride0": 2}, 8, 3.), ("float", {}, 32, 3.),
            ("float", {"use_adj": True, "dilation": 2, "stride0": 2}, 32,
             "border")]


@pytest.mark.parametrize("itype,extra,F_head,offsets", B4_CASES)
def test_gather_backward_kernel_paths(dev, itype, extra, F_head, offsets):
    """B4 against its plain version through the shared boxes, the global
    path, the reflections at the borders, pt, dilation, stride0 and the
    channel groups; its counts say which path the entries took."""
    cfg = dict(dict(ps=3, stride0=1, pt=1, dilation=1, reflect_bounds=True,
                    use_adj=False, itype=itype), **extra)
    size = 128 if offsets == "scatter" else H
    vid, weights, flows, g = _gather_bwd_case(dev, itype, cfg, F_head,
                                              offsets, H=size, W=size)
    stats = torch.zeros(4, dtype=torch.int64, device=dev)
    g_k = agg_cuda.nl_gather_stack_bwd(vid, weights, flows, g, cfg,
                                       (True, True, True), stats=stats)
    torch.cuda.synchronize()
    g_p = agg_cuda._gather_bwd_plain(vid, weights, flows, g, cfg,
                                     (True, True, True))
    assert_grad_close(g_k[0], g_p[0], "g_vid")
    assert_grad_close(g_k[1], g_p[1], "g_weights")
    if itype == "int":
        assert not g_k[2].any() and not g_p[2].any()
    else:
        off = _off_integer(flows[..., 1]) & _off_integer(flows[..., 2])
        assert_grad_close(g_k[2][off], g_p[2][off], "g_flows")
    flush, direct, n_global, n_all = stats.tolist()
    assert n_all == weights.numel()
    if offsets == "scatter":
        assert n_global > 0 and direct > 0     # the global path ran
    else:
        assert flush > 0


def test_gather_backward_weights_and_offsets_are_deterministic(dev):
    """B4's g_weights and g_flows are summed by one thread each, in a fixed
    order: two calls agree bitwise (g_vid's atomics need not)."""
    cfg = dict(ps=3, stride0=1, pt=1, dilation=1, reflect_bounds=True,
               use_adj=False, itype="float")
    args = _gather_bwd_case(dev, "float", cfg, 8, 3.)
    g1 = agg_cuda.nl_gather_stack_bwd(*args, cfg, (True, True, True))
    g2 = agg_cuda.nl_gather_stack_bwd(*args, cfg, (True, True, True))
    assert torch.equal(g1[1], g2[1]) and torch.equal(g1[2], g2[2])


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


@pytest.mark.parametrize("body", ["compiled", "run-time", "swept"])
@pytest.mark.parametrize("anchor", [True, False])
@pytest.mark.parametrize("nslots", [1, 4, 5, 8, 9, 16, 17, 32, 33, 64])
def test_search_kernel_keeps_64_ranked_slots(dev, nslots, anchor, body):
    """B1 bitwise against its plain version at list sizes on both sides of
    4, 8, 16, 32 and 64 ranked slots (anchored, the list keeps nslots + 1
    and swaps the self cell for cell 0 at the end), on the body with
    (ps, F) = (3, 8) compiled in, on the run-time body and on the swept
    body of (ps, ws) = (3, 9), up to the 64 ranked slots it keeps."""
    v0, v1, flows = _inputs(dev)
    k = nslots + bool(anchor)
    kw = dict(KW, k=k, anchor=anchor)
    if body == "swept":
        kw.update(ws=9, stride1=1)
    stats = torch.zeros(4, dtype=torch.int64, device=dev)
    nls_cuda.COMPILED_BODY = body != "run-time"
    try:
        d, cells = nls_cuda.nls_topk(v0, v1, flows, stats=stats, **kw)
    finally:
        nls_cuda.COMPILED_BODY = True
    d_p, cells_p = nls_cuda.nls_topk_plain(v0, v1, flows, **kw)
    assert d.shape[-1] == k
    assert torch.equal(d, d_p) and torch.equal(cells, cells_p)
    swept, per_cell, mixed, _ = stats.tolist()
    assert swept + per_cell + mixed == B * HD * T * H * W * 3
    assert (swept + mixed > 0) == (body == "swept")


# B1's swept body (csrc/nls_topk_fwd.cu's STNLS_NLS_SWEPT) at the
# denoiser's search (ps 3, ws 9, F 16, anchored) and at RVRT's arguments on
# it (F 32, prod, W_t 1); RVRT's own pair (ps 1, ws 9) is not listed and
# runs the run-time body. Frames are wide enough that window positions
# round across columns 64 and 128.
SWEPT_CASES = [dict(ps=3, ws=9, F=16, dist_type="l2", anchor=True, wt=1),
               dict(ps=3, ws=9, F=32, dist_type="prod", anchor=False, wt=0),
               dict(ps=1, ws=9, F=32, dist_type="prod", anchor=False, wt=0)]


def _swept_inputs(dev, F, W_t, H=24, W=176, seed=7):
    """Videos [1, 2, 3, F, H, W] and a fractional flow for every slot."""
    rng = np.random.default_rng(seed)

    def t(x):
        return torch.from_numpy(x.astype(np.float32)).to(dev)

    return (t(rng.standard_normal((1, HD, T, F, H, W))),
            t(rng.standard_normal((1, HD, T, F, H, W))),
            t(3 * rng.standard_normal((1, 1, T, W_t, 2, H, W))))


@pytest.mark.parametrize("full_ws", [True, False])
@pytest.mark.parametrize("case", SWEPT_CASES)
def test_swept_search_kernel_matches_plain(dev, case, full_ws):
    """B1's dists and cells equal the plain version's bitwise. On a listed
    pair the counts show slots on the sweep and on the mixed sweep
    (borders, and positions that round across a power of two), and, with
    full_ws off, windows that leave the frame on the per-cell loop; on an
    unlisted pair every slot is on the per-cell loop."""
    from stnls_tpu_torch.ops import cuda_lib
    c = dict(case)
    F = c.pop("F")
    listed = cuda_lib.load().stnls_nls_topk_swept(c["ps"], c["ws"])
    assert listed == (c["ps"] == 3)
    W_t = min(2 * c["wt"] + 1, T)
    v0, v1, flows = _swept_inputs(dev, F, W_t)
    kw = dict(c, stride0=1, stride1=1, k=9, full_ws=full_ws)
    stats = torch.zeros(4, dtype=torch.int64, device=dev)
    d, cells = nls_cuda.nls_topk(v0, v1, flows, stats=stats, **kw)
    d_p, cells_p = nls_cuda.nls_topk_plain(v0, v1, flows, **kw)
    assert torch.equal(d, d_p) and torch.equal(cells, cells_p)
    swept, per_cell, mixed, _ = stats.tolist()
    assert swept + per_cell + mixed == d[..., 0].numel() * W_t
    if listed:
        assert swept > 0 and mixed > 0 and (per_cell > 0) == (not full_ws)
    else:
        assert swept == mixed == 0


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


def _sp_inputs(dev, stride, seed=4, K=6, F=F, H=H, W=W, fill_frame=False,
               dense=False):
    """Video, weights (negative ones and ones below 1e-8 included) and
    offsets with exact half-integers and -1e8 fills, on the stride grid;
    with `fill_frame`, every slot of frame 0 is a fill; `dense`: every
    weight in (0, 1] and no fill, so every slot is live."""
    rng = np.random.default_rng(seed)
    nH, nW = (H - 1) // stride + 1, (W - 1) // stride + 1

    def t(x):
        return torch.from_numpy(np.asarray(x, np.float32)).to(dev)

    weights = rng.random((B, HD, T, nH, nW, K))
    flows = np.stack([rng.integers(-1, 2, (B, HD, T, nH, nW, K)),
                      3 * rng.standard_normal((B, HD, T, nH, nW, K)),
                      3 * rng.standard_normal((B, HD, T, nH, nW, K))], -1)
    if dense:
        return tuple(t(x) for x in (
            rng.standard_normal((B, HD, T, F, H, W)), 1. - weights, flows))
    if K > 5:
        weights[..., 0], weights[..., 1] = -0.25, 5e-9
        flows[..., 2, 1:] = (0.5, -1.5)
        flows[..., 3, 1:] = (1.5, -0.5)
    flows[:, :, 1, ::3, 1::2, min(5, K - 1), :] = -1e8
    if fill_frame:
        flows[:, :, 0] = -1e8
    return (t(rng.standard_normal((B, HD, T, F, H, W))), t(weights),
            t(flows))


# keys beyond the ops' keywords: the frame (H, W), channels a head (F),
# slots (K), a frame of -1e8 fills, every slot live ("dense"), the
# cotangent's layout B8 reads ("layout": "channels_last" or "planar";
# default: the wrapper's size rule), B7's and B10's run-time body at ps =
# 3 ("body": "run_time"), and the shared memory of the centre table (a
# small one takes the slots in chunks)
SP_CASES = [dict(), dict(stride=2, dilation=2, use_adj=True, ps=4, pt=2),
            dict(reflect_bounds=False),
            dict(H=37, W=53, F=3, layout="channels_last"),
            dict(H=37, W=53, F=3, layout="planar"),
            dict(H=37, W=53, stride=2, F=1, K=1, use_adj=True),
            dict(H=20, W=150, F=16, K=20, layout="channels_last"),
            dict(F=33, ps=5, dilation=2, layout="channels_last"),
            dict(F=33, K=20, pt=2, layout="planar"),
            dict(fill_frame=True, pt=2),
            dict(F=16, K=20, table_bytes=2048, pt=2,
                 layout="channels_last"),
            dict(H=37, W=53, K=20, table_bytes=2048, stride=2,
                 layout="planar"),
            # a video above SCATTER_CHANNELS_LAST_MIN: B8 reads a
            # channels-last cotangent by the wrapper's own rule
            dict(H=128, W=96, K=4),
            # both sides of B7's and B10's body rule (ps = 3 compiled in,
            # forced to the run-time body); F not a multiple of their 4
            # channels a lane (3, 33), F = 2 (2 a lane), a run-time ps
            # (5), 2 passes of a lane (F = 130), every slot live
            dict(body="run_time"),
            dict(body="run_time", stride=2, dilation=2, pt=2),
            dict(stride=2, dilation=2, use_adj=True, pt=2),
            dict(F=3, ps=5), dict(F=33, pt=2, body="run_time"),
            dict(F=2, K=20),
            dict(F=130, H=16, W=24, K=3),
            dict(F=130, H=16, W=24, K=3, body="run_time"),
            dict(dense=True), dict(dense=True, ps=5),
            dict(dense=True, body="run_time")]
# ScatterAdd also takes strideIn != strideOut and an explicit output size
SCATTER_CASES = SP_CASES + [dict(stride=2, strideOut=1),
                            dict(strideOut=2, outH=24, outW=40),
                            dict(H=37, W=53, strideOut=2, outH=30, outW=61,
                                 F=16, reflect_bounds=False,
                                 layout="channels_last")]
_SP_INPUT_KEYS = ("K", "F", "H", "W", "fill_frame", "dense")


def _sp_layout(monkeypatch, extra):
    """Force the cotangent's layout B8 reads where the case names one,
    B7's and B10's run-time body, and the centre table's shared memory of
    B8 and B9."""
    forced = {"channels_last": 0, "planar": sys.maxsize}.get(
        extra.get("layout"))
    if forced is not None:
        monkeypatch.setattr(agg_sp_cuda, "SCATTER_CHANNELS_LAST_MIN", forced)
    if extra.get("body") == "run_time":
        monkeypatch.setattr(agg_sp_cuda, "COMPILED_BODY", False)
    if "table_bytes" in extra:
        monkeypatch.setattr(agg_sp_cuda, "TABLE_BYTES", extra["table_bytes"])


def _check_sp_backward(bwd, plain_bwd, args, cfg, bitwise):
    n0 = bwd.launches
    g_k = bwd(*args, cfg, (True, True, True))
    torch.cuda.synchronize()
    assert bwd.launches == n0 + 1
    g_p = plain_bwd(*args, cfg, (True, True, True))
    for a, b, name in zip(g_k, g_p, ("g_vid", "g_weights")):
        assert float(b.abs().max()) > 0
        assert_grad_close(a, b, name)
    assert not g_k[2].any() and not g_p[2].any()
    # what one gradient alone asks for: bitwise where the kernel sums it
    # without atomics (`bitwise`: g_vid, g_weights; B8 both, B10 g_w)
    for needs in ((True, False, False), (False, True, False)):
        g_one = bwd(*args, cfg, needs)
        for a, b, need, exact, name in zip(g_one, g_k, needs, bitwise,
                                           ("g_vid", "g_weights")):
            assert (a is None) != need
            if need and exact:
                assert torch.equal(a, b)
            elif need:
                assert_grad_close(a, b, name)


def _scatter_cfg(extra):
    s = extra.get("stride", 1)
    return dict(ps=extra.get("ps", 3), strideIn=s,
                strideOut=extra.get("strideOut", s), pt=extra.get("pt", 1),
                dilation=extra.get("dilation", 1),
                reflect_bounds=extra.get("reflect_bounds", True),
                use_adj=extra.get("use_adj", False),
                outH=extra.get("outH", 0), outW=extra.get("outW", 0))


def _pool_cfg(extra):
    return dict(ps=extra.get("ps", 3), stride0=extra.get("stride", 1),
                pt=extra.get("pt", 1), dilation=extra.get("dilation", 1),
                reflect_bounds=extra.get("reflect_bounds", True),
                use_adj=extra.get("use_adj", False))


@pytest.mark.parametrize("extra", SCATTER_CASES)
def test_scatter_add_kernels_match_plain(dev, extra, monkeypatch):
    _sp_layout(monkeypatch, extra)
    cfg = _scatter_cfg(extra)
    vid, weights, flows = _sp_inputs(
        dev, cfg["strideIn"], **{k: extra[k] for k in _SP_INPUT_KEYS
                                 if k in extra})
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
                       dict(cfg, outH=out.shape[-2], outW=out.shape[-1]),
                       bitwise=(True, True))


@pytest.mark.parametrize("extra", SP_CASES)
def test_pool_kernels_match_plain(dev, extra, monkeypatch):
    _sp_layout(monkeypatch, extra)
    cfg = _pool_cfg(extra)
    vid, weights, flows = _sp_inputs(
        dev, cfg["stride0"], **{k: extra[k] for k in _SP_INPUT_KEYS
                                if k in extra})
    n0 = agg_sp_cuda.nl_pool.launches
    # B9 writes every element, the ones no tap reaches too: its output
    # takes the block of a freed tensor of NaNs
    junk = torch.full(agg_sp_cuda._pool_out_shape(vid, cfg), float("nan"),
                      device=dev)
    del junk
    out = agg_sp_cuda.nl_pool(vid, weights, flows, **cfg)
    torch.cuda.synchronize()
    assert agg_sp_cuda.nl_pool.launches == n0 + 1
    assert_close(out, agg_sp_cuda.nl_pool_plain(vid, weights, flows, **cfg),
                 "out")
    g = torch.randn(out.shape, device=dev,
                    generator=torch.Generator(dev).manual_seed(0))
    _check_sp_backward(agg_sp_cuda.nl_pool_bwd, agg_sp_cuda._pool_bwd_plain,
                       (vid, weights, flows, g), cfg, bitwise=(False, True))


@pytest.mark.parametrize("layout", ["channels_last", "planar"])
def test_pool_and_scatter_backward_are_deterministic(dev, layout,
                                                     monkeypatch):
    """B9's output, B8's g_vid and g_w (in either layout of the cotangent)
    and B10's g_w equal bitwise on two calls."""
    _sp_layout(monkeypatch, dict(layout=layout))
    vid, weights, flows = _sp_inputs(dev, 1, F=16, K=8, H=48, W=64)
    cfg = _pool_cfg({})
    outs = [agg_sp_cuda.nl_pool(vid, weights, flows, **cfg)
            for _ in range(2)]
    assert torch.equal(*outs)
    g_pool = torch.randn(outs[0].shape, device=dev,
                         generator=torch.Generator(dev).manual_seed(2))
    g_ws = [agg_sp_cuda.nl_pool_bwd(vid, weights, flows, g_pool, cfg,
                                    (True, True, False))[1]
            for _ in range(2)]
    assert float(g_ws[0].abs().max()) > 0
    assert torch.equal(*g_ws)
    scfg = dict(_scatter_cfg({}), outH=48, outW=64)
    g = torch.randn((B, HD, T, 16, 48, 64), device=dev,
                    generator=torch.Generator(dev).manual_seed(1))
    grads = [agg_sp_cuda.nl_scatter_add_bwd(vid, weights, flows, g, scfg,
                                            (True, True, False))
             for _ in range(2)]
    assert torch.equal(grads[0][0], grads[1][0])
    assert torch.equal(grads[0][1], grads[1][1])


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


# B5 and B6: B5 bitwise against the plain volume in its compiled and
# run-time bodies, B6 at 1e-4 * max|ref|, over patch sizes 1-7, widths
# that are not a multiple of 4, the search's options, chunk mode, a
# window of one frame (wt = 0: every centre is its query's pixel, so
# neighbouring queries read neighbouring pixels, the case where B5 and B6
# are slower than their first design) and the cotangents of the search
# menu (every cell, the per-frame top-2 of anchor_each, the top-10 of
# remove_ref_frame); stride1 = 2 and reflected taps at the 32^2 frames'
# edges spread a slot's corners wide.
VOLUME_BODY_CASES = [
    (1, 1, {}, "dense"), (1, 2, {}, "each"), (1, 3, dict(itype="int"), "dense"),
    (3, 3, dict(dilation=2), "dense"), (3, 8, {}, "dense"), (3, 8, {}, "each"),
    (3, 8, {}, "remove_ref_frame"), (3, 8, dict(stride1=2.), "dense"),
    (3, 8, dict(chunk=True), "dense"), (3, 16, dict(use_adj=True), "each"),
    (5, 8, dict(itype="int"), "each"), (5, 32, dict(dist_type="prod"), "dense"),
    (7, 2, dict(dilation=2, use_adj=True), "dense"),
    (7, 16, dict(stride0=2), "each"),
    (1, 32, dict(stride1=2., dist_type="prod"), "dense"),
    (1, 16, dict(wt=0, stride1=1.), "each"), (3, 8, dict(wt=0), "dense")]


def _volume_cotangent(dev, vol, aux, kind, wt, dist_type):
    from stnls_tpu_torch.ops.nls_k import aux_to_inds3
    from stnls_tpu_torch.search.non_local_search import _self_action_topk
    gen = torch.Generator(dev).manual_seed(4)
    if kind == "dense":
        g_d = torch.randn(vol.shape, device=dev, generator=gen)
        return torch.where(vol.isfinite(), g_d, torch.zeros_like(g_d))
    sa, mode, k = {"each": ("anchor_each", "each", 2),
                   "remove_ref_frame": ("remove_ref_frame", "all", 10)}[kind]
    d = vol.detach().requires_grad_()
    ds, _ = _self_action_topk(d, aux_to_inds3(aux, d.shape), self_action=sa,
                              topk_mode=mode, k=k, wt=wt, dist_type=dist_type)
    g_d, = torch.autograd.grad(ds, d, torch.randn(ds.shape, device=dev,
                                                  generator=gen))
    return g_d


@pytest.mark.parametrize("ps,F,extra,cotangent", VOLUME_BODY_CASES)
def test_volume_kernel_bodies_match_plain(dev, ps, F, extra, cotangent,
                                          monkeypatch):
    from stnls_tpu_torch.ops.nls import search_centres
    from stnls_tpu_torch.ops.nls_k import search_aux
    extra = dict(extra)
    c = dict(ws=5, wt=1, ps=ps, stride0=1, stride1=0.5, dist_type="l2",
             dilation=1, use_adj=False, itype="float")
    if extra.pop("chunk", False):
        v0, v1, flows = _chunk_inputs(dev, seed=14, F=F)
        t0, Tl = CHUNK["T_local"], CHUNK["T_local"]
        v0, v1 = _chunk(v0, t0), _chunk(v1, t0)
        flows = flows[:, :, t0:t0 + Tl].contiguous()
        c.update(wt=CHUNK["wt"], query_t0=t0, T_global=CHUNK["T"])
    else:
        c.update(extra)
        v0, v1, flows = _any_ps_inputs(dev, F, c["stride0"], seed=6)
        if c["wt"] == 0:
            flows = flows[:, :, :, :0]      # the query's own frame only
    ctr = [x.contiguous() for x in search_centres(
        v0.shape, flows, wt=c["wt"], stride0=c["stride0"], itype=c["itype"],
        T_global=c.get("T_global"))]
    plain = nls_vol_cuda.nls_volume_plain(v0, v1, *ctr, **c)
    for compiled in (True, False):
        monkeypatch.setattr(nls_vol_cuda, "COMPILED_BODY", compiled)
        vol = nls_vol_cuda.nls_volume(v0, v1, *ctr, **c)
        assert torch.equal(vol, plain), f"B5, compiled body {compiled}"
    aux = search_aux(v0.shape, flows, ws=5, wt=c["wt"], stride0=c["stride0"],
                     stride1=c["stride1"], itype=c["itype"],
                     query_t0=c.get("query_t0"), T_global=c.get("T_global"))
    g_d = _volume_cotangent(dev, vol, aux, cotangent, c["wt"],
                            c["dist_type"])
    active = int(((g_d != 0) & vol.isfinite()).sum())
    assert active > 0
    cfg = dict(c, full_ws=True)
    stats = torch.zeros(4, dtype=torch.int64, device=dev)
    g_k = nls_vol_cuda.nls_volume_bwd(v0, v1, *ctr, g_d, cfg, stats=stats)
    torch.cuda.synchronize()
    g_p = nls_vol_cuda.nls_volume_bwd_plain(v0, v1, *ctr, g_d, cfg)
    assert_grad_close(g_k[0], g_p[0], "g_vid0")
    assert_grad_close(g_k[1], g_p[1], "g_vid1")
    assert float(g_p[1].abs().max()) > 0
    offs = (_off_integer(aux["dh"]).all(4), _off_integer(aux["dw"]).all(4))
    for a, b, off, name in zip(g_k[2:], g_p[2:], offs,
                               ("g_ctr_h", "g_ctr_w")):
        if c["itype"] == "int":
            assert not a.any() and not b.any()
        elif off.any():
            assert_grad_close(a[off], b[off], name)
    into1, into0, stores, n_active = stats.tolist()
    assert n_active == active and into1 > 0 and into0 > 0 and stores == 0


# search_bench's arguments (benchmarks/search_bench.py: ps 7, F 9 a head,
# ws 21, wt 3 over T 3, K 10 anchored) on small frames
SEARCH_BENCH_KW = dict(ws=21, wt=3, ps=7, stride0=1, stride1=1, k=10,
                       anchor=True, dist_type="l2")


@pytest.mark.parametrize("itype", ["float", "int"])
def test_search_kernels_at_search_bench_arguments(dev, itype):
    """B1 (bitwise) and B2 (seeded cotangent) at search_bench's (ps 7,
    F 9, ws 21, W_t 3), the run-time body, against their plain versions."""
    rng = np.random.default_rng(14)
    Hs = 40

    def t(x):
        return torch.from_numpy(x.astype(np.float32)).to(dev)

    v0 = t(rng.standard_normal((1, 3, 3, 9, Hs, Hs)))
    v1 = t(rng.standard_normal((1, 3, 3, 9, Hs, Hs)))
    flows = t(rng.standard_normal((1, 1, 3, 2, 2, Hs, Hs)) + 0.3)
    kw = dict(SEARCH_BENCH_KW, itype=itype)
    d, cells = nls_cuda.nls_topk(v0, v1, flows, **kw)
    d_p, cells_p = nls_cuda.nls_topk_plain(v0, v1, flows, **kw)
    assert torch.equal(d, d_p) and torch.equal(cells, cells_p)
    geo = cells_geometry(flows, cells, H=Hs, W=Hs, ws=21, wt=3, stride0=1,
                         stride1=1, itype=itype)
    g_d = t(rng.standard_normal(tuple(d.shape)))
    args = (v0, v1, geo["prop_h"], geo["prop_w"], geo["tj_k"],
            geo["valid"], g_d, dict(ps=7, stride0=1, dist_type="l2",
                                    dilation=1, use_adj=False, itype=itype))
    g_k = nls_cuda.nls_topk_bwd(*args)
    g_p = nls_cuda.nls_topk_bwd_plain(*args)
    off = ((geo["prop_h"] % 1 > 1e-3) & (geo["prop_h"] % 1 < 1 - 1e-3)
           & (geo["prop_w"] % 1 > 1e-3) & (geo["prop_w"] % 1 < 1 - 1e-3))
    for a, b, name in zip(g_k, g_p, ("g_vid0", "g_vid1", "g_h", "g_w")):
        if name in ("g_h", "g_w"):
            if itype == "int":
                assert not a.any() and not b.any()
                continue
            a, b = a[off], b[off]
        assert_grad_close(a, b, name)


@pytest.mark.parametrize("itype", ["float", "int"])
def test_refine_backward_kernel_matches_plain_lattice(dev, itype):
    """RefineSearch on the card (selection in bands, B2 for the winners'
    gradient) against the whole plain lattice under autograd: dists,
    offsets and the gradients into the video and the given offsets."""
    from stnls_tpu_torch.search import RefineSearch, refinement
    rng = np.random.default_rng(15)
    Hs, K = 24, 5
    vid = rng.standard_normal((1, 3, 2 * 9, Hs, Hs)).astype(np.float32)
    fk = np.empty((1, 2, 3, Hs, Hs, K, 3), np.float32)
    fk[..., 0] = rng.integers(-1, 2, fk.shape[:-1])
    fk[..., 1:] = np.round(2 * rng.standard_normal(fk.shape[:-1] + (2,))) \
        + (0.3 if itype == "float" else 0.)
    refine = RefineSearch(21, 3, 3, 10, ps=7, nheads=2, stride0=1,
                          self_action="anchor", itype=itype)
    outs = {}
    for route in ("kernels", "lattice"):
        v = torch.from_numpy(vid).to(dev).requires_grad_()
        f = torch.from_numpy(fk).to(dev).requires_grad_()
        n0 = nls_cuda.nls_topk_bwd.launches
        if route == "kernels":
            saved = refinement.SELECT_CELLS
            refinement.SELECT_CELLS = 2 * 3 * Hs * K * 9 * 5   # 5 rows
            try:
                d, i = refine(v, v, f)
            finally:
                refinement.SELECT_CELLS = saved
        else:
            v6 = v.reshape(1, 3, 2, 9, Hs, Hs).transpose(1, 2)
            d, i = refinement._lattice_route(v6, v6, f, refine.cfg)
        w = torch.arange(1, d.shape[-1] + 1, device=dev)
        g = torch.autograd.grad((torch.where(d.isfinite(), d, 0.) * w).sum()
                                + i.float().sum(), (v, f),
            allow_unused=True, materialize_grads=True)
        outs[route] = (d, i, g, nls_cuda.nls_topk_bwd.launches - n0)
    (d, i, g, n), (d_p, i_p, g_p, n_p) = outs["kernels"], outs["lattice"]
    assert n == 1 and n_p == 0
    assert_close(d, d_p, "dists")
    assert_close(i, i_p, "offsets")
    for a, b, name in zip(g, g_p, ("g_vid", "g_offsets")):
        assert_grad_close(a, b, name)


def test_scatter_path_on_the_card_matches_the_cpu(dev):
    """The int search (B1), its slot labels, NonLocalScatter and the
    gradient of mean(stack.sum(2)^2) into the video (B2 and autograd) at
    64^2 on the card against the same steps on the CPU: offsets and labels
    equal, stack and mask at 1e-4 (the card's index_add_ adds with
    atomics), the gradient at 1e-4 * max|ref|. The video's scale, 2^-5,
    keeps the dists near 0.1, so that the dists' cotangent is non-zero at
    most (query, slot) pairs and B2 is held to the plain backward."""
    from stnls_tpu_torch.search import NonLocalSearch
    from stnls_tpu_torch.graph_opts import scatter_labels
    from stnls_tpu_torch.agg import NonLocalScatter
    rng = np.random.default_rng(3)
    n, T_, HD_, F_ = 64, 4, 2, 4
    vid = (2. ** -5 * rng.standard_normal((1, T_, HD_ * F_, n, n))) \
        .astype(np.float32)
    flows = np.round(2 * rng.standard_normal((1, T_, 2, 2, n, n))) \
        .astype(np.float32)
    search = NonLocalSearch(5, 1, 3, 8, nheads=HD_, self_action="anchor",
                            itype="int")
    res = {}
    for where in ("cpu", dev):
        v = torch.from_numpy(vid).to(where).requires_grad_()
        fl = torch.from_numpy(flows).to(where)
        n0 = nls_cuda.nls_topk.launches, nls_cuda.nls_topk_bwd.launches
        d, i = search(v, v, fl)
        _, lab = scatter_labels.run(fl, i, 5, 1, 1, 1, n, n, True)
        stack, mask = NonLocalScatter(ps=3, stride0=1)(
            v, torch.softmax(-10. * d, -1), i, lab)
        g, g_d = torch.autograd.grad(stack.sum(2).pow(2).mean(), (v, d))
        assert float((g_d != 0).float().mean()) > 0.5
        res[str(where)] = [x.detach().cpu() for x in (i, lab, stack, mask,
                                                      g)]
        launched = (nls_cuda.nls_topk.launches - n0[0],
                    nls_cuda.nls_topk_bwd.launches - n0[1])
    assert launched == (1, 1)
    i_c, lab_c, stack_c, mask_c, g_c = res["cpu"]
    i_g, lab_g, stack_g, mask_g, g_g = res[str(dev)]
    assert torch.equal(i_g, i_c) and torch.equal(lab_g, lab_c)
    assert_close(stack_g, stack_c, "stack")
    assert torch.equal(mask_g, mask_c)
    assert float(g_c.abs().max()) > 0
    assert_grad_close(g_g, g_c, "g_vid")


def test_gather_kernel_clamps_frames_beyond_one_reflection(dev):
    """agg_bench's offsets (round(3 * normal) at T = 3) send many frames
    outside the video after one reflection: B3 clamps them into it, and
    so does its plain version."""
    from stnls_tpu_torch import agg_bench
    cfg = dict(agg_bench.SMALL, H=48, W=48)
    vid, weights, flows = agg_bench.make_inputs(cfg, dev)
    for itype in ("float", "int"):
        out = agg_cuda.nl_gather_stack(vid, weights, flows, ps=3, stride0=1,
                                       itype=itype)
        ref = agg_cuda.nl_gather_stack_plain(vid, weights, flows, ps=3,
                                             stride0=1, itype=itype)
        assert_close(out, ref, f"B3 {itype}")


def test_spans_open_around_the_kernels_forward_and_backward(dev):
    """On CUDA tensors the search and the gather open their spans
    (utils/spans) around B1-B4: the lazy route's stages, the gather
    stack, and the explicit backwards of the search and of the gather."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from stnls_tpu_torch.agg.gather import NonLocalGather
    from stnls_tpu_torch.search.non_local_search import NonLocalSearch
    rng = np.random.default_rng(4)

    def t(shape, scale=1.):
        return torch.from_numpy(
            (scale * rng.standard_normal(shape)).astype(np.float32)).to(dev)

    vid = t((B, T, HD * F, H, W)).requires_grad_()
    fflow, bflow = t((B, T, 2, H, W), 1.5), t((B, T, 2, H, W), 1.5)
    search = NonLocalSearch(5, 1, ps=3, k=4, nheads=HD, self_action="anchor")
    gather = NonLocalGather(ps=3, stride0=1)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        dists, inds = search(vid, vid, fflow, bflow)
        v6 = vid.reshape(B, T, HD, F, H, W).transpose(1, 2)
        stack = gather(v6, torch.softmax(-10. * dists, -1), inds)
        stack.pow(2).mean().backward()
        torch.cuda.synchronize(dev)
    names = {e.name for e in prof.events()}
    assert {"stnls.search", "stnls.search.flow", "stnls.search.select",
            "stnls.search.geometry", "stnls.search.dists.bwd",
            "stnls.agg.gather", "stnls.agg.gather.bwd"} <= names
    kernels = {r.key for r in prof.key_averages()
               if r.device_type == DeviceType.CUDA}
    for base in ("nls_topk_kernel", "nls_topk_bwd_query_kernel",
                 "agg_gather_fwd_pixel_kernel", "agg_gather_bwd_tile_kernel"):
        assert any(base in k for k in kernels), (base, sorted(kernels))


# -- the lazy route's geometry: G1 and its flow backward G2 --
# one dict a case: the int path, stride1 1, full_ws off, flows for every
# head (HDf = HD), W_t flow slots (the reference frame's included), no
# anchor, a temporal chunk with its halo, flows that reach past the
# frame's edges (reflected), a strided query grid, a stride1 that is not a
# power of two
GEO_CASES = [{}, dict(itype="int"), dict(stride1=1), dict(full_ws=False),
             dict(hdf=HD), dict(slots="W_t"), dict(anchor=False),
             dict(chunk=True), dict(amp=12.), dict(stride0=2),
             dict(itype="int", anchor=False, full_ws=False, hdf=HD,
                  slots="W_t"),
             dict(itype="int", chunk=True, amp=12.),
             dict(stride1=1, full_ws=False, chunk=True, hdf=HD, amp=12.),
             dict(stride1=0.75), dict(stride1=0.75, amp=12., slots="W_t")]
GEO_NAMES = ("prop_h", "prop_w", "tj_k", "valid", "inds")


def _geometry_case(dev, itype="float", stride1=0.5, full_ws=True, hdf=1,
                   slots="W_t-1", anchor=True, chunk=False, amp=3.,
                   stride0=1, seed=9, K=7, wt=2, Tq=4):
    """Seeded flows and uniform window cells on 24 x 20 frames, Tq query
    frames (a chunk at t0 Tq of 2 Tq frames, halo Tq); the arguments of
    nls_geometry."""
    from stnls_tpu_torch.ops.geometry import num_queries
    Hc, Wc = 24, 20
    T_g = 2 * Tq if chunk else Tq
    W_t = min(2 * wt + 1, T_g)
    St = W_t if slots == "W_t" else W_t - 1
    nH, nW = num_queries(Hc, Wc, stride0)
    gen = torch.Generator(dev).manual_seed(seed)
    flows = amp * torch.randn((B, hdf, Tq, St, 2, nH, nW), device=dev,
                              generator=gen)
    cells = torch.randint(0, W_t * 25, (B, HD, Tq, nH, nW, K), device=dev,
                          generator=gen, dtype=torch.int32)
    kw = dict(H=Hc, W=Wc, ws=5, wt=wt, stride0=stride0,
              stride1=1 if itype == "int" else stride1, full_ws=full_ws,
              itype=itype, anchor=anchor)
    if chunk:
        kw.update(query_t0=Tq, T_global=T_g, halo=Tq)
    return flows, cells, kw


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


@pytest.mark.parametrize("case", GEO_CASES)
def test_geometry_kernel_matches_plain_bitwise(dev, case):
    """G1's positions, frames, validity and offsets are the plain
    composition's (cells_geometry, the stacked offsets, the anchored slot)
    bit for bit, on the CPU and, where stride1 is a power of two, on the
    card (torch divides a CUDA tensor by a scalar through its reciprocal);
    its frames are int32."""
    flows, cells, kw = _geometry_case(dev, **case)
    n0 = nls_geometry_cuda.nls_geometry.launches
    out = nls_geometry_cuda.nls_geometry(flows, cells, **kw)
    assert nls_geometry_cuda.nls_geometry.launches == n0 + 1
    assert out[2].dtype == torch.int32
    refs = [nls_geometry_cuda.nls_geometry_plain(flows.cpu(), cells.cpu(),
                                                 **kw)]
    if math.frexp(kw["stride1"])[0] == 0.5:
        refs.append(nls_geometry_cuda.nls_geometry_plain(flows, cells, **kw))
    for ref in refs:
        ref = ref[:2] + (ref[2].to(torch.int32),) + ref[3:]
        for a, b, name in zip(out, ref, GEO_NAMES):
            b = b.to(dev)
            assert a.shape == b.shape and a.dtype == b.dtype, name
            assert torch.equal(_bits(a), _bits(b)), name
    assert out[3].any()
    if kw["anchor"]:
        assert not out[4][..., 0, :].any()


@pytest.mark.parametrize("case", [{}, dict(anchor=False), dict(hdf=HD),
                                  dict(slots="W_t"), dict(chunk=True),
                                  dict(amp=12.), dict(inds_grad=False),
                                  dict(itype="int"),
                                  dict(wt=5, Tq=6, chunk=True, hdf=HD)])
def test_geometry_backward_kernel_matches_autograd(dev, case):
    """G2's flow gradient against autograd through the plain composition,
    at 1e-4 * max|ref| (the sums over heads and cells run in another
    order); zero in the int path. The last case's 11 slots take G2 two
    passes over the cells."""
    case = dict(case)
    inds_grad = case.pop("inds_grad", True)
    flows, cells, kw = _geometry_case(dev, **case)
    gen = torch.Generator(dev).manual_seed(3)
    g_pos = [torch.randn(cells.shape, device=dev, generator=gen)
             for _ in range(2)]
    g_inds = torch.randn(tuple(cells.shape) + (3,), device=dev, generator=gen)

    def grad(fn):
        f = flows.clone().requires_grad_()
        ph, pw, _, _, inds = fn(f, cells, **kw)
        loss = (ph * g_pos[0]).sum() + (pw * g_pos[1]).sum()
        if inds_grad and inds.is_floating_point():
            loss = loss + (inds * g_inds).sum()
        return torch.autograd.grad(loss, f)[0]

    n0 = nls_geometry_cuda.nls_geometry_bwd.launches
    g_k = grad(nls_geometry_cuda.nls_geometry)
    is_float = kw["itype"] == "float"
    assert nls_geometry_cuda.nls_geometry_bwd.launches == n0 + is_float
    g_p = grad(nls_geometry_cuda.nls_geometry_plain)
    assert_grad_close(g_k, g_p, "g_flows")
    assert bool(g_k.any()) == is_float
    if is_float:
        assert torch.equal(g_k, grad(nls_geometry_cuda.nls_geometry))


def test_lazy_search_launches_the_geometry_kernel_once_a_call(dev):
    """Each lazy-route search call launches G1 once, and its backward G2
    once where the flows need a gradient."""
    from stnls_tpu_torch.search.non_local_search import NonLocalSearch
    v0, v1, flows = _inputs(dev, 2)
    search = NonLocalSearch(5, 1, ps=3, k=6, nheads=HD,
                            self_action="anchor", stride1=0.5)
    n0 = nls_geometry_cuda.nls_geometry.launches
    nb0 = nls_geometry_cuda.nls_geometry_bwd.launches
    with torch.no_grad():
        search(v0, v1, flows)
    f = flows.clone().requires_grad_()
    dists, inds = search(v0, v1, f)
    assert nls_geometry_cuda.nls_geometry.launches == n0 + 2
    (dists.pow(2).sum() + inds.pow(2).sum()).backward()
    assert nls_geometry_cuda.nls_geometry_bwd.launches == nb0 + 1
    assert f.grad.abs().max() > 0


def test_rvrt_on_the_card_matches_the_reference(dev):
    """RVRT at its small test size (torch_port_helpers.RVRT_SMALL) on the
    card, forward and backward: each of its 8 alignments launches B1, G1
    and B3 once, and its backward B4 and B2 once; out, the loss, every
    gradient and the selection against the plain reference on the CPU,
    judged at the card's selection. Tolerances as the CPU test's
    (test_torch_rvrt.py), the card's cuBLAS and cuDNN summing in other
    orders again."""
    from bench_h100.reference import rvrt256 as rvrt_reference
    from torch_port_helpers import rvrt_case, rvrt_train_step
    cfg, params, clip = rvrt_case(8)
    kernels = (nls_cuda.nls_topk, nls_geometry_cuda.nls_geometry,
               agg_cuda.nl_gather_stack, agg_cuda.nl_gather_stack_bwd,
               nls_cuda.nls_topk_bwd)
    before = [k.launches for k in kernels]
    run = rvrt_train_step(cfg, params, clip, dev)
    n_align = 4 * (cfg["T"] // 2 - 1)
    assert [k.launches - b for k, b in zip(kernels, before)] == \
        [n_align] * len(kernels)
    nums = rvrt_reference.judge(clip, run, params, cfg, "train")
    tols = dict(out_err=3e-6, loss_err=1e-6, grad_err=1e-5,
                dists_err=1e-4, inds_err=1e-4, flow_err=1e-5)
    assert all(nums[k] <= tol for k, tol in tols.items()), nums


# RVRT's conv kinds on the card: (input [B,C,D,H,W], c_out, kernel,
# stride, padding, channels-last input as RSTBWithInputConv passes it)
FRAME_CONV_KINDS = [((2, 16, 3, 64, 64), 24, 3, (1, 2, 2), (0, 1, 1), False),
                    ((2, 48, 2, 32, 32), 16, 3, (1, 1, 1), (0, 1, 1), True),
                    ((2, 32, 4, 32, 32), 16, 1, (1, 1, 1), (0, 0, 0), True),
                    ((1, 16, 3, 96, 96), 3, 3, (1, 1, 1), (0, 1, 1), False)]


@pytest.mark.parametrize("kind", FRAME_CONV_KINDS)
@pytest.mark.parametrize("one_frame_chunks", [False, True])
def test_frame_conv_on_the_card_matches_cudnn_in_float64(dev, kind,
                                                         one_frame_chunks,
                                                         monkeypatch):
    """RVRT's FrameConv on the card: the output and the input and bias
    gradients are cuDNN's, the weight gradient (float32 GEMMs over chunks
    of frames, TF32 off; chunks of one frame with UNFOLD_BYTES cut) within
    1e-5 of max|ref| of cuDNN's float64 weight gradient of the same
    tensors, and one weight gradient counted."""
    from stnls_tpu_torch.models import rvrt
    shape, c_out, k, stride, padding, channels_last = kind
    if one_frame_chunks:
        monkeypatch.setattr(rvrt, "UNFOLD_BYTES", 1)
    B, C, D, H, W = shape
    gen = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn((B, D, H, W, C), generator=gen, device=dev) \
        .permute(0, 4, 1, 2, 3)
    if not channels_last:
        x = x.contiguous()
    conv = torch.nn.Conv3d(C, c_out, (1, k, k), stride, padding).to(dev)
    xa = x.clone().requires_grad_()
    n0 = rvrt.FrameConv.calls
    out = rvrt.conv3d(conv, xa)
    g = torch.randn(out.shape, generator=gen, device=dev)
    gx, gw, gb = torch.autograd.grad(out, (xa, conv.weight, conv.bias), g)
    assert rvrt.FrameConv.calls == n0 + 1
    xr = x.clone().requires_grad_()
    ref_out = torch.nn.functional.conv3d(xr, conv.weight, conv.bias, stride,
                                         padding)
    rx, rb = torch.autograd.grad(ref_out, (xr, conv.bias), g)
    assert torch.equal(out, ref_out)
    assert torch.equal(gb, rb)
    assert_grad_close(gx, rx, "input gradient", tol=1e-6)
    ref_w = torch.ops.aten.convolution_backward(
        g.double(), x.double(), conv.weight.double(), None, stride, padding,
        (1, 1, 1), False, (0, 0, 0), 1, (False, True, False))[1]
    assert_grad_close(gw, ref_w, "weight gradient", tol=1e-5)


def test_dinat_on_the_card_launches_b5_b6_b9_b10_once_a_layer(dev):
    """DiNAT at its small test size (torch_port_helpers.DINAT_SMALL: the
    published structure, dilations 8, 4, 2 and 1) on the card, forward
    and backward: each attention layer counts one
    NeighborhoodAttention.calls and launches B5 and B9 once, its backward
    B6 and B10 once; no B1 or B3 (nor their backwards) run. The logits,
    the loss and every gradient against the plain reference on the CPU,
    at the CPU test's tolerances (test_torch_dinat.py): the card's
    cuBLAS and cuDNN sum in other orders again."""
    from stnls_tpu_torch.models.dinat import NeighborhoodAttention
    from torch_port_helpers import DINAT_SMALL, dinat_case, dinat_errors, \
        dinat_reference_step, dinat_train_step
    net, params, images, labels = dinat_case(4)
    once = (nls_vol_cuda.nls_volume, agg_sp_cuda.nl_pool,
            nls_vol_cuda.nls_volume_bwd, agg_sp_cuda.nl_pool_bwd)
    never = (nls_cuda.nls_topk, nls_cuda.nls_topk_bwd,
             agg_cuda.nl_gather_stack, agg_cuda.nl_gather_stack_bwd)
    before = [k.launches for k in once + never] + \
        [NeighborhoodAttention.calls]
    run = dinat_train_step(net, images, labels, dev)
    torch.cuda.synchronize()
    layers = sum(DINAT_SMALL["depths"])
    assert [k.launches for k in once + never] + \
        [NeighborhoodAttention.calls] == [b + n for b, n in zip(
            before, [layers] * 4 + [0] * 4 + [layers])]
    out, loss, grad = dinat_errors(run, dinat_reference_step(
        params, images, labels))
    assert out <= 1e-6 and loss <= 1e-6 and grad <= 1e-5, (out, loss, grad)


# -- the search-flow walk: F1 and its flow backward F2 --
# (B, T, H, W, wt, stride0, noise amplitude, drift), as the CPU test's edge
# cases (test_torch_flow_geometry.SEARCH_FLOW_EDGES): W_t = T, wt 1-3 at
# T 10, strides that do not divide odd frames, walks that reflect and
# clamp (fflow's and bflow's drift plus noise), B 2, flows of integers
# (every sample on the integer lattice); "1080p" is config 7's shape, its
# own smooth flows (matrix_steps.make_inputs)
FLOW_CASES = {
    "window_is_clip": (1, 4, 12, 10, 2, 1, 1.5, None),
    "window_wider_than_clip": (1, 3, 11, 9, 3, 1, 1.5, None),
    "wt1_T10": (1, 10, 10, 12, 1, 1, 1., None),
    "wt2_T10": (1, 10, 11, 9, 2, 1, 1., None),
    "wt3_T10_B2": (2, 10, 12, 13, 3, 1, 1., None),
    "stride2_odd": (1, 5, 13, 11, 2, 2, 1.5, None),
    "stride3_odd": (1, 6, 11, 14, 2, 3, 1.5, None),
    "reflect_and_clamp": (1, 10, 9, 11, 3, 1, 0.02, (1.64, 1.3)),
    "far_outside": (1, 7, 9, 8, 3, 1, 6., None),
    "wide_window": (1, 12, 20, 24, 5, 1, 1.5, None),
    "integer_flows": (2, 6, 16, 15, 2, 1, 2., "round"),
    "B2_stride2": (2, 7, 33, 40, 3, 2, 2., None),
    "1080p": None,
}


def _flow_case(dev, case, seed=11):
    """fflow, bflow [B,T,2,H,W] on the card, wt and stride0 of a case."""
    if FLOW_CASES[case] is None:
        from stnls_tpu_torch import matrix_steps
        _, ff, bf = matrix_steps.make_inputs("align1080p_fwd", seed,
                                             device=dev)
        return ff, bf, 3, 1
    B, T, Hc, Wc, wt, stride0, amp, drift = FLOW_CASES[case]
    gen = torch.Generator(dev).manual_seed(seed)
    ff, bf = (amp * torch.randn((B, T, 2, Hc, Wc), device=dev, generator=gen)
              for _ in range(2))
    if drift == "round":
        ff, bf = ff.round(), bf.round()
    elif drift is not None:
        ff, bf = ff + drift[0], bf - drift[1]
    return ff, bf, wt, stride0


@pytest.mark.parametrize("case", FLOW_CASES)
def test_search_flow_kernel_matches_plain_bitwise(dev, case):
    """F1's offsets are the plain walk's on the same card, bit for bit, in
    one launch."""
    from stnls_tpu_torch.ops import flow_cuda, flow_ops
    ff, bf, wt, stride0 = _flow_case(dev, case)
    n0 = flow_cuda.search_flow.launches
    out = flow_cuda.search_flow(ff, bf, wt, stride0)
    assert flow_cuda.search_flow.launches == n0 + 1
    ref = flow_ops.search_flow_plain(ff, bf, wt, stride0)
    assert out.shape == ref.shape and out.dtype == ref.dtype
    assert torch.equal(out, ref)
    assert torch.equal(out, flow_ops.search_flow(ff, bf, wt, stride0))


@pytest.mark.parametrize("case,need", [
    ("window_is_clip", (True, True)), ("wt3_T10_B2", (True, True)),
    ("stride3_odd", (True, True)), ("reflect_and_clamp", (True, True)),
    ("far_outside", (True, True)), ("wide_window", (True, True)),
    ("integer_flows", (True, True)), ("B2_stride2", (False, True)),
    ("wt2_T10", (True, False))])
def test_search_flow_backward_kernel_matches_autograd(dev, case, need):
    """F2's flow gradients against autograd through the plain walk, at
    1e-5 * max|ref| (atomics add in another order), with its subgradients:
    every walk's first slot samples at its integer query position, and
    with integer flows every slot does. Only the flows that require a
    gradient get one."""
    from stnls_tpu_torch.ops import flow_cuda, flow_ops
    ff, bf, wt, stride0 = _flow_case(dev, case)
    out = flow_ops.search_flow_plain(ff, bf, wt, stride0)
    gen = torch.Generator(dev).manual_seed(5)
    g = torch.randn(out.shape, device=dev, generator=gen)
    # the positions slot 1 samples at: the query grid, integers
    nH, nW = out.shape[-2:]
    ref_h = (torch.arange(nH, device=dev) * stride0).float()
    assert torch.equal(ref_h, ref_h.floor())
    if case == "integer_flows":
        assert torch.equal(out, out.round())

    def grads(fn):
        flows = [f.clone().requires_grad_(n) for f, n in zip((ff, bf), need)]
        return torch.autograd.grad(fn(*flows, wt, stride0), [
            f for f in flows if f.requires_grad], g)

    n0 = flow_cuda.search_flow_bwd.launches
    g_k = grads(flow_cuda.search_flow)
    assert flow_cuda.search_flow_bwd.launches == n0 + 1
    g_p = grads(flow_ops.search_flow_plain)
    assert len(g_k) == sum(need)
    for a, b in zip(g_k, g_p):
        assert float(b.abs().max()) > 0
        assert_grad_close(a, b, "g_flow", tol=1e-5)
    direct = flow_cuda.search_flow_bwd(ff, bf, g, wt, stride0, need=need)
    assert [x is None for x in direct] == [not n for n in need]


def test_search_with_flows_launches_the_walk_kernel_once(dev, monkeypatch):
    """A four-argument NonLocalSearch call on the card launches F1 once and
    never runs the plain walk; its backward into the flows launches F2
    once."""
    from stnls_tpu_torch.ops import flow_cuda, flow_ops
    from stnls_tpu_torch.search.non_local_search import NonLocalSearch
    plain_calls = []
    plain = flow_ops.search_flow_plain
    monkeypatch.setattr(flow_ops, "search_flow_plain",
                        lambda *a, **k: plain_calls.append(1) or plain(*a, **k))
    rng = np.random.default_rng(12)
    vid = torch.from_numpy(rng.standard_normal((B, T, HD * F, H, W))
                           .astype(np.float32)).to(dev)
    ff, bf = (torch.from_numpy((1.5 * rng.standard_normal((B, T, 2, H, W)))
                               .astype(np.float32)).to(dev).requires_grad_()
              for _ in range(2))
    search = NonLocalSearch(5, 1, ps=3, k=4, nheads=HD, self_action="anchor")
    n0 = flow_cuda.search_flow.launches
    nb0 = flow_cuda.search_flow_bwd.launches
    dists, inds = search(vid, vid, ff, bf)
    assert flow_cuda.search_flow.launches == n0 + 1
    (dists.pow(2).sum() + inds.pow(2).sum()).backward()
    assert flow_cuda.search_flow_bwd.launches == nb0 + 1
    assert not plain_calls
    assert float(ff.grad.abs().max()) > 0 and float(bf.grad.abs().max()) > 0


def test_search_flow_wrapper_raises_on_what_the_kernels_do_not_take(dev):
    from stnls_tpu_torch.ops import flow_cuda
    ff = torch.zeros((1, 4, 2, 8, 8), device=dev)
    with pytest.raises(TypeError):
        flow_cuda.search_flow(ff.double(), ff.double(), 1)
    with pytest.raises(ValueError):
        flow_cuda.search_flow(ff, ff.cpu(), 1)
    with pytest.raises(ValueError):
        flow_cuda.search_flow(ff, ff[:, :3], 1)
    with pytest.raises(ValueError):
        flow_cuda.search_flow(ff[:, :, :1], ff[:, :, :1], 1)
    with pytest.raises(ValueError):
        flow_cuda.search_flow(ff, ff, 0)
    with pytest.raises(ValueError):
        flow_cuda.search_flow_bwd(ff, ff, torch.zeros((1, 4, 1, 2, 8, 8),
                                                      device=dev), 1, 1)
