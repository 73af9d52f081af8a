"""Crediting device operations to the program's spans (spans.py), on
synthetic Chrome events as test_bench_h100_trace.py builds them, and the
readers' own traced pass on the CPU."""

from _small import BENCH, SIZES
from bench_h100 import common, spans, trace

GEO, SEARCH = "stnls.search.geometry", "stnls.search"
DBWD = "stnls.search.dists.bwd"
EVAL = spans.EVALUATE + ": "


def _x(cat, name, ts, dur, tid=1, **args):
    return dict(ph="X", cat=cat, name=name, ts=ts, dur=dur, tid=tid,
                args=args)


def _kernel(name, launch_ts, ts, dur, corr, tid=1):
    """A launch on host thread `tid` and the device operation it made."""
    return [_x("cuda_runtime", "cudaLaunchKernel", launch_ts, 1, tid=tid,
               correlation=corr),
            _x("kernel", name, ts, dur, tid=7, correlation=corr)]


def _events():
    """Two steps: a forward in nested spans, a convolution, an unspanned
    op, and a backward on the autograd thread (tid 2) with an explicit
    .bwd span."""
    seq = "Sequence number"
    return [
        _x("user_annotation", trace.STEP_MARK, 0, 100),
        _x("user_annotation", trace.STEP_MARK, 100, 100),
        _x("user_annotation", SEARCH, 5, 50),
        _x("user_annotation", GEO, 10, 20),
        # seq 7: an op that made no node, then the where that made node 7
        _x("cpu_op", "aten::mul", 6, 2, **{seq: 7}),
        _x("cpu_op", "aten::where", 21, 3, **{seq: 7}),
        _x("cpu_op", "_SearchDists", 25, 2, **{seq: 8}),
        *_kernel("elementwise_kernel", 12, 20, 5, 1),
        *_kernel("void nls_topk_kernel<1, 2, false>(float*)", 15, 26, 8, 2),
        *_kernel("vectorized_elementwise_kernel", 40, 41, 4, 3),
        _x("cpu_op", "aten::convolution", 60, 5),
        *_kernel("cudnn::conv_fwd_kernel", 61, 62, 6, 4),
        *_kernel("reduce_kernel", 70, 71, 2, 5),
        # the backward, on the autograd thread
        _x("cpu_op", EVAL + "SumBackward0", 105, 5, tid=2, **{seq: 9}),
        *_kernel("fill_kernel", 106, 107, 1, 6, tid=2),
        _x("cpu_op", EVAL + "WhereBackward0", 120, 10, tid=2, **{seq: 7}),
        _x("cpu_op", "WhereBackward0", 121, 8, tid=2, **{seq: 7}),
        *_kernel("where_kernel", 122, 123, 3, 7, tid=2),
        _x("cpu_op", EVAL + "_SearchDistsBackward", 140, 20, tid=2,
           **{seq: 8}),
        _x("user_annotation", DBWD, 142, 16, tid=2),
        *_kernel("void nls_topk_bwd_query_kernel<4, 1>(float*)", 143, 150,
                 5, 8, tid=2),
        *_kernel("copy_kernel", 144, 156, 2, 9, tid=2),
        # the backward's device time of a kernel after the last step
        *_kernel("late_kernel", 190, 210, 2, 10, tid=2),
        _x("gpu_user_annotation", GEO, 20, 10, tid=7),
    ]


def test_forward_ops_go_to_the_innermost_span():
    res = spans.credit(_events())
    assert res.steps == 2
    t = res.table
    assert t[(GEO, "B1")] == [8., 1]              # launched inside both
    assert t[(SEARCH, "glue")] == [4., 1]
    assert t[(None, "conv")] == [6., 1]
    assert res.ms(GEO, "B1") == 8. / 1e3 / 2
    assert res.names == {SEARCH, GEO, DBWD}


def test_backward_ops_go_to_the_span_of_the_forward_op_that_made_the_node():
    """where_kernel (node 7) goes to the geometry span, where the where
    that made node 7 ran, not to the earlier op with the same number in
    the search span; fill_kernel (node 9, whose maker the trace does not
    hold) is unspanned."""
    got = {}
    for (span, layer), (us, n) in spans.credit(_events()).table.items():
        got.setdefault(span, {})[layer] = (us, n)
    assert got[GEO] == {"glue": (5. + 3., 2), "B1": (8., 1)}
    assert got[SEARCH] == {"glue": (4., 1)}
    assert got[DBWD] == {"B2": (5., 1), "glue": (2., 1)}
    # reduce_kernel and fill_kernel; late_kernel ran after the window
    assert got[None] == {"conv": (6., 1), "glue": (2. + 1., 2)}


def test_an_explicit_bwd_span_takes_precedence():
    events = [e for e in _events() if e["name"] != DBWD]
    got = spans.credit(events).table
    # without the .bwd span, node 8's maker (_SearchDists, inside the
    # geometry span) takes B2 and its copy
    assert got[(GEO, "B2")] == [5., 1]
    assert DBWD not in {k[0] for k in got}


def test_the_glue_entries_partition_torch_glue_ms():
    events = _events()
    res = spans.credit(events)
    tr = trace.reduce_events(events)
    glue = sum(res.ms(s) for s in res.names | {None})
    assert glue == tr.layer_ms_per_step("glue")
    assert glue == common.reader("torch_glue_ms").read(dict(trace=tr))
    per_layer = {}
    for (_, layer), (us, _) in res.table.items():
        per_layer[layer] = per_layer.get(layer, 0.) + us
    assert per_layer == {lay: tr.layer_ms_per_step(lay) * 1e3 * tr.steps
                         for lay in ("glue", "conv", "B1", "B2")}


def test_the_trace_and_its_readers_are_the_same_with_spans_and_without():
    with_spans = _events()
    without = [e for e in with_spans
               if not e["name"].startswith(spans.PREFIX)]
    a, b = trace.reduce_events(with_spans), trace.reduce_events(without)
    assert (a.ops, a.steps, a.window, a.busy_us) == \
        (b.ops, b.steps, b.window, b.busy_us)
    assert [g for _, g in a.gaps] == [g for _, g in b.gaps]
    work = {"B1": (0, 67e12 * 1e-5), "B2": (3.35e12 * 1e-6, 0),
            "step": 1e9}
    for m in BENCH["per_layer"]:
        if m["name"] in ("geometry_ms", "flow_ms", "glue_unspanned_ms"):
            continue
        ctx = [dict(trace=tr, busy=(90., 200.), work=work, mean_step_s=0.1)
               for tr in (a, b)]
        reader = common.reader(m["name"])
        assert reader.read(ctx[0]) == reader.read(ctx[1]), m["name"]


def test_no_span_reads_nothing_and_an_empty_span_reads_zero():
    events = [e for e in _events() if not e["name"].startswith(spans.PREFIX)]
    res = spans.credit(events)
    assert res.names == set()
    assert res.ms(None) is None and res.ms(GEO) is None
    events = _events() + [_x("user_annotation", "stnls.search.flow", 2, 2)]
    res = spans.credit(events)
    assert res.ms("stnls.search.flow") == 0.
    assert res.ms("stnls.search.volume") is None


def test_innermost_on_nested_ranges_and_threads():
    r = [_x("user_annotation", "a", 0, 100), _x("user_annotation", "b", 10,
                                                20),
         _x("user_annotation", "c", 40, 10), _x("user_annotation", "d", 0,
                                                 100, tid=2)]
    pts = [(1, 5), (1, 15), (1, 35), (1, 45), (1, 150), (2, 45), (3, 45)]
    got = [e["name"] if e else None for e in spans._innermost(r, pts)]
    assert got == ["a", "b", "a", "c", None, "d", None]


def test_the_readers_own_pass_on_the_cpu():
    """The readers' pass runs the cell's own step (the align cell at its
    small size, on the CPU): it sees the search's spans, and without
    device operations reads nothing."""
    cfg = dict(common.config("align1080p"), **SIZES["align1080p"])
    ctx = dict(cfg=cfg, mode="train", mean_step_s=1.)
    res = spans.of_run(ctx)
    assert {SEARCH, "stnls.search.flow", "stnls.search.select", GEO,
            DBWD} <= res.names
    for name in ("geometry_ms", "flow_ms", "glue_unspanned_ms"):
        assert common.reader(name).read(ctx) is None
    assert spans.of_run(ctx) is res
