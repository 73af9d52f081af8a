"""The package's spans (utils/spans): the ranges a CPU torch.profiler
records at the search route's, the backward's and the aggregation's
boundaries, each inside the span that encloses it."""

import numpy as np
import pytest
import torch

from stnls_tpu_torch.agg import NonLocalScatter
from stnls_tpu_torch.agg.gather import NonLocalGather
from stnls_tpu_torch.graph_opts import scatter_labels
from stnls_tpu_torch.nn.non_local_attn import NonLocalAttention
from stnls_tpu_torch.ops import agg_cuda
from stnls_tpu_torch.search.non_local_search import NonLocalSearch, \
    search_route
from stnls_tpu_torch.search.refinement import RefineSearch
from stnls_tpu_torch.utils.config import ConfigDict
from stnls_tpu_torch.utils.spans import span

B, HD, T, F, H, W = 1, 2, 3, 4, 16, 16
STAGES = ("qkv", "search", "normz", "agg", "proj")


def _spans(prof):
    """{span name: [the names of the ranges around it, innermost first]}
    of every stnls.* range the profile recorded (the last of each name)."""
    out = {}
    for evt in prof.events():
        if not evt.name.startswith("stnls."):
            continue
        chain, up = [], evt.cpu_parent
        while up is not None:
            if up.name.startswith("stnls."):
                chain.append(up.name)
            up = up.cpu_parent
        out[evt.name] = chain
    return out


def _video_and_flows(seed=0, grad=False):
    rng = np.random.default_rng(seed)

    def t(x):
        return torch.from_numpy(x.astype(np.float32)).requires_grad_(grad)

    vid = t(rng.standard_normal((B, T, HD * F, H, W)))
    fflow = t(1.5 * rng.standard_normal((B, T, 2, H, W)))
    bflow = t(1.5 * rng.standard_normal((B, T, 2, H, W)))
    return vid, fflow, bflow


def test_span_is_a_profiler_range_and_needs_no_profiler():
    with span("stnls.test.outer"):
        with span("stnls.test.inner"):
            x = torch.ones(3) * 2
    assert float(x.sum()) == 6.
    with torch.profiler.profile() as prof:
        with span("stnls.test.outer"):
            with span("stnls.test.inner"):
                torch.ones(3).mul_(2)
    assert _spans(prof) == {"stnls.test.outer": [],
                            "stnls.test.inner": ["stnls.test.outer"]}


def test_lazy_route_opens_flow_select_and_geometry_inside_the_search():
    search = NonLocalSearch(5, 1, ps=3, k=4, nheads=HD,
                            self_action="anchor")
    vid, fflow, bflow = _video_and_flows()
    assert search_route(search.cfg, (B, HD, T, F, H, W)) == "topk"
    with torch.profiler.profile() as prof:
        search(vid, vid, fflow, bflow)
    spans = _spans(prof)
    assert spans["stnls.search"] == []
    for stage in ("flow", "select", "geometry"):
        assert spans[f"stnls.search.{stage}"] == ["stnls.search"], stage
    assert "stnls.search.volume" not in spans


def test_volume_route_opens_the_volume_span():
    search = NonLocalSearch(5, 1, ps=3, k=4, nheads=HD,
                            self_action="anchor_each", topk_mode="each")
    vid, fflow, bflow = _video_and_flows()
    assert search_route(search.cfg, (B, HD, T, F, H, W)) == "volume"
    with torch.profiler.profile() as prof:
        search(vid, vid, fflow, bflow)
    spans = _spans(prof)
    assert spans["stnls.search.volume"] == ["stnls.search"]
    assert spans["stnls.search.flow"] == ["stnls.search"]
    assert not {"stnls.search.select", "stnls.search.geometry"} & set(spans)


def test_backward_spans_of_the_search_and_the_gather():
    """search_dists' backward opens stnls.search.dists.bwd. On CPU tensors
    the gather stack is its plain version under autograd, so the B4
    entry, nl_gather_stack_bwd, is called as the card's backward calls
    it."""
    search = NonLocalSearch(5, 1, ps=3, k=4, nheads=HD,
                            self_action="anchor")
    gather = NonLocalGather(ps=3, stride0=1)
    vid, fflow, bflow = _video_and_flows(grad=True)
    with torch.profiler.profile() as prof:
        dists, inds = search(vid, vid, fflow, bflow)
        weights = torch.softmax(-10. * dists, dim=-1)
        v6 = vid.reshape(B, T, HD, F, H, W).transpose(1, 2)
        stack = gather(v6, weights, inds)
        stack.pow(2).mean().backward()
    spans = _spans(prof)
    assert spans["stnls.search.dists.bwd"] == []
    assert spans["stnls.agg.gather"] == []
    assert torch.isfinite(vid.grad).all() and vid.grad.abs().sum() > 0

    cfg = dict(ps=3, stride0=1, pt=1, dilation=1, reflect_bounds=True,
               use_adj=False, itype="float")
    v6, weights, inds = v6.detach(), weights.detach(), inds.detach()
    with torch.profiler.profile() as prof:
        g_vid, g_w, g_f = agg_cuda.nl_gather_stack_bwd(
            v6.contiguous(), weights, inds.float().contiguous(),
            torch.ones_like(stack), cfg, (True, True, True))
    assert _spans(prof) == {"stnls.agg.gather.bwd": []}
    assert g_vid.shape == v6.shape and g_w.shape == weights.shape


@pytest.mark.parametrize("attn_timer", [False, True])
def test_attention_opens_its_five_stage_spans(attn_timer):
    attn_cfg = {"nheads": HD, "embed_dim": F, "use_attn_projection": True,
                "use_attn_flow": True, "attn_timer": attn_timer}
    search_cfg = {"search_name": "nls", "ws": 5, "wt": 1, "ps": 3, "k": 4,
                  "nheads": HD, "stride0": 1, "self_action": "anchor",
                  "itype": "float", "dist_type": "l2"}
    normz_cfg = {"normz_name": "softmax", "normz_scale": 10,
                 "dist_type": "l2"}
    agg_cfg = {"agg_name": "gather", "ps": 3, "stride0": 1,
               "itype": "float"}
    model = NonLocalAttention(attn_cfg, search_cfg, normz_cfg, agg_cfg)
    vid, fflow, bflow = _video_and_flows()
    with torch.profiler.profile() as prof:
        model(vid, ConfigDict(fflow=fflow, bflow=bflow))
    spans = _spans(prof)
    for stage in STAGES:
        assert spans[f"stnls.attn.{stage}"] == [], stage
    assert spans["stnls.search"] == ["stnls.attn.search"]
    assert spans["stnls.search.geometry"] == ["stnls.search",
                                              "stnls.attn.search"]
    assert spans["stnls.agg.gather"] == ["stnls.attn.agg"]
    assert set(model._times) == (set(STAGES) if attn_timer else set())


def test_refine_and_scatter_open_their_spans():
    rng = np.random.default_rng(3)
    vid = torch.from_numpy(
        rng.standard_normal((B, T, HD * F, H, W)).astype(np.float32))
    K = 3
    inds = np.zeros((B, HD, T, H, W, K, 3), np.float32)
    inds[..., 1:] = np.round(rng.standard_normal(inds.shape[:-1] + (2,)))
    refine = RefineSearch(5, 1, 3, K, ps=3, nheads=HD, stride0=1,
                          itype="int")
    with torch.profiler.profile() as prof:
        dists, found = refine(vid, vid, torch.from_numpy(inds))
    assert _spans(prof)["stnls.search.refine"] == []

    _, labels = scatter_labels.run(None, found, 5, 1, 1, 1, H, W, True)
    weights = torch.ones(B, HD, T, H, W, K)
    v6 = vid.reshape(B, T, HD, F, H, W).transpose(1, 2)
    with torch.profiler.profile() as prof:
        stack, mask = NonLocalScatter(ps=1, stride0=1)(v6, weights, found,
                                                       labels)
    assert _spans(prof) == {"stnls.agg.scatter": []}
    assert float(mask.sum()) == B * HD * T * H * W * K


def _backward_spans(prof):
    """{backward node name: {the stnls.* ranges around the forward op that
    made it, innermost first}} of every autograd node the profile ran,
    matched by sequence number (the last forward op recorded with it)."""
    def chain(evt):
        out, up = [], evt.cpu_parent
        while up is not None:
            if up.name.startswith("stnls."):
                out.append(up.name)
            up = up.cpu_parent
        return tuple(out)

    def in_backward(evt):
        up = evt.cpu_parent
        while up is not None:
            if up.name.startswith("autograd::engine::evaluate_function"):
                return True
            up = up.cpu_parent
        return False

    maker = {}
    for evt in sorted(prof.events(), key=lambda e: e.time_range.start):
        if evt.sequence_nr >= 0 and not evt.name.startswith(
                "autograd::engine") and not in_backward(evt):
            maker[evt.sequence_nr] = chain(evt)
    found = {}
    prefix = "autograd::engine::evaluate_function: "
    for evt in prof.events():
        if evt.name.startswith(prefix) and evt.sequence_nr in maker:
            found.setdefault(evt.name[len(prefix):], set()).add(
                maker[evt.sequence_nr])
    return found


def test_rvrt_opens_its_spans_with_the_search_and_gather_inside_align():
    """RVRT forward and backward at a small size (two clips): the Swin
    layers, the alignment and the flow composition open their spans; the
    search's and the gather's spans open inside stnls.rvrt.align, and
    the backward nodes of the search (B2's, _SearchDistsBackward), of the
    gather and of the Swin layers were made inside their spans."""
    from stnls_tpu_torch.models import RVRT
    from torch_port_helpers import RVRT_MODEL_KEYS, rvrt_case
    cfg, params, clip = rvrt_case(0, T=4)
    net = RVRT(k=cfg["K"], **{k: cfg[k] for k in RVRT_MODEL_KEYS})
    net.load_state_dict(params)
    with torch.profiler.profile() as prof:
        out = net(clip["lq"], clip["fflow"], clip["bflow"])
        out.pow(2).mean().backward()
    spans = _spans(prof)
    for name in ("swin", "align", "flow"):
        assert spans[f"stnls.rvrt.{name}"] == [], name
    for name in ("stnls.search.select", "stnls.search.geometry",
                 "stnls.agg.gather"):
        assert spans[name] == ["stnls.rvrt.align"], name
    assert spans["stnls.search.dists.bwd"] == []
    made = _backward_spans(prof)
    assert made["_SearchDistsBackward"] == {
        ("stnls.search.geometry", "stnls.rvrt.align")}
    assert ("stnls.agg.gather", "stnls.rvrt.align") in \
        set().union(*made.values())
    assert made["SoftmaxBackward0"] == {("stnls.rvrt.swin",),
                                        ("stnls.rvrt.align",)}


def test_dinat_opens_its_span_with_the_search_and_pool_inside():
    """DiNAT forward and backward at its small test size: each attention
    core opens stnls.dinat.na, the search's volume route and the pool
    open their spans inside it, and the backward nodes of the volume
    (B6's, _SearchVolumeBackward), of the pool (on the CPU its plain
    version's) and of the softmax were made inside their spans; the
    linear layers around the core lie outside every span."""
    from torch_port_helpers import dinat_case
    net, _, images, labels = dinat_case(0, B=1)
    with torch.profiler.profile() as prof:
        out = net(images)
        torch.nn.functional.cross_entropy(out, labels[:1]).backward()
    spans = _spans(prof)
    assert spans["stnls.dinat.na"] == []
    assert spans["stnls.search"] == ["stnls.dinat.na"]
    assert spans["stnls.search.volume"] == ["stnls.search", "stnls.dinat.na"]
    assert spans["stnls.agg.pool"] == ["stnls.dinat.na"]
    made = _backward_spans(prof)
    assert made["_SearchVolumeBackward"] == {
        ("stnls.search.volume", "stnls.search", "stnls.dinat.na")}
    assert ("stnls.agg.pool", "stnls.dinat.na") in set().union(
        *made.values())
    assert made["SoftmaxBackward0"] == {("stnls.dinat.na",)}
    assert made["AddmmBackward0"] == {()}
