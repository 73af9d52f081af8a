"""The reduction of a profiler trace to the per-layer metrics."""

from bench_h100 import common, trace, work


def _x(cat, name, ts, dur, tid=1, **args):
    return dict(ph="X", cat=cat, name=name, ts=ts, dur=dur, tid=tid,
                args=args)


def test_kernels_are_sorted_into_layers_and_idle_is_the_union():
    events = [
        _x("user_annotation", trace.STEP_MARK, 0, 100),
        _x("user_annotation", trace.STEP_MARK, 100, 100),
        _x("cpu_op", "aten::convolution", 5, 20),
        _x("cuda_runtime", "cudaLaunchKernel", 10, 2, correlation=1),
        _x("kernel", "cudnn::conv_fwd_kernel<...>", 20, 30, tid=7,
           correlation=1),
        _x("cpu_op", "aten::add", 40, 10),
        _x("cuda_runtime", "cudaLaunchKernel", 42, 2, correlation=2),
        _x("kernel", "elementwise_kernel", 40, 20, tid=7, correlation=2),
        _x("cuda_runtime", "cudaLaunchKernel", 110, 2, correlation=3),
        _x("kernel", "void nls_topk_kernel<3, 8, true>(float*)", 120, 40,
           tid=7, correlation=3),
        _x("kernel", "void nls_topk_bwd_query_kernel<4, 1>(float*)", 170,
           10, tid=7, correlation=4),
        _x("cpu_op", "aten::sort", 160, 30),
        _x("gpu_memset", "Memset (Device)", 500, 10, tid=7),
        _x("gpu_user_annotation", "search", 0, 200, tid=7),
    ]
    tr = trace.reduce_events(events)
    assert tr.steps == 2 and tr.window == (0, 200)
    layers = {name: lay for name, _, _, lay in tr.ops}
    assert layers["cudnn::conv_fwd_kernel<...>"] == "conv"
    assert layers["elementwise_kernel"] == "glue"
    assert layers["void nls_topk_kernel<3, 8, true>(float*)"] == "B1"
    assert layers["void nls_topk_bwd_query_kernel<4, 1>(float*)"] == "B2"
    assert "Memset (Device)" not in layers
    # busy: [20, 60] and [120, 160] and [170, 180]
    assert tr.busy_us == 40 + 40 + 10
    assert tr.gaps[0] == ("aten::add", 60) or tr.gaps[0][1] == 60
    assert [round(g, 6) for _, g in tr.gaps] == [60, 20, 20, 10]
    assert dict(tr.gaps)["aten::sort"] == 10
    assert tr.layer_ms_per_step("B1") == 40 / 1e3 / 2
    assert tr.layer_ms_per_step("B3") is None
    ctx = dict(trace=tr, work={"B1": (0, 67e12 * 1e-5)})
    assert abs(work.kernel_share(ctx, "B1") - 100 * 1e-2 / 0.02) < 1e-9
    assert work.kernel_share(ctx, "B2") is None


def test_port_kernel_names():
    assert trace.port_kernel("void agg_gather_bwd_tile_kernel<8>(...)") \
        == "B4"
    assert trace.port_kernel("agg_gather_fwd_pixel_kernel") == "B3"
    assert trace.port_kernel("void nls_topk_kernel<1, 2, false>") == "B1"
    assert trace.port_kernel("at::native::sort_kernel") is None


def test_device_busy_is_the_union_of_the_device_operations():
    events = [
        _x("kernel", "a", 10, 30, tid=7),
        _x("kernel", "b", 20, 30, tid=8),
        _x("gpu_memcpy", "Memcpy DtoD", 70, 5, tid=7),
        _x("cuda_runtime", "cudaLaunchKernel", 0, 100),
        _x("cpu_op", "aten::add", 0, 100),
        dict(ph="i", cat="kernel", name="mark", ts=0),
    ]
    assert trace.busy_us(events) == 40 + 5
    idle = common.reader("device_idle")
    assert idle.read(dict(busy=(45., 90.))) == 50.
    assert idle.read(dict(busy=None)) is None
