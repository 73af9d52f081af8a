"""The dinat224 configuration on the CPU at a small size: its shapes and
parameter count, its work against chip_smoke's counts and torch's flop
counter, its readers, a whole run that is correct, and a run broken
underneath (an altered answer, half the batch left out of the loss, the
reference in TF32) that is not.

Importing this file gives the shared tests (_small.SIZES) dinat224's small
size: the published structure at widths 8 to 64 in heads of 8, k 3, 96^2
images (maps 24, 12, 6, 3) and the dilations map // k alternating with 1.
"""

import math

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import _small
from _small import BENCH
from bench_h100 import calibrate, common, spans, work, work_window
from bench_h100.run import run_cell

CELL, CONFIG = "dinat224.train", "dinat224"
DINAT_SMALL = dict(B=2, H=96, W=96, embed_dim=8, num_heads=[1, 2, 4, 8],
                   depths=[2, 2, 2, 1], kernel_size=3,
                   dilations=[[1, 8], [1, 4], [1, 2], [1]])
_small.SIZES.setdefault(CONFIG, DINAT_SMALL)
ADAPTER = common.adapter(CONFIG)
CPU = torch.device("cpu")


def _cfg(**size):
    return dict(common.config(CONFIG), **dict(DINAT_SMALL, **size))


def _run(seed=2 ** 31 + 99, **size):
    return run_cell(torch, BENCH, CELL, seed, 0.05, 0, CPU,
                    size=dict(DINAT_SMALL, **size))


def test_the_config_is_dinat_tiny_at_its_published_widths():
    cfg = common.config(CONFIG)
    assert (cfg["B"], cfg["H"], cfg["W"], cfg["num_classes"]) == \
        (128, 224, 224, 1000)
    assert cfg["depths"] == [len(d) for d in cfg["dilations"]] == \
        [3, 4, 18, 5]
    assert [c // h for c, h in zip(
        (64, 128, 256, 512), cfg["num_heads"])] == [32] * 4
    # dilation map // k alternating with 1, level by level
    maps = [cfg["H"] // 4 >> i for i in range(4)]
    assert all(set(d) <= {1, n // cfg["kernel_size"]}
               for d, n in zip(cfg["dilations"], maps))
    assert [max(d) for d in cfg["dilations"]] == [8, 4, 2, 1]
    from bench_h100.reference import dinat224 as reference
    assert reference.parameter_count(cfg) == cfg["parameters"] == 27901582
    assert common.config(CONFIG)["reduced"] == ["B"] == next(
        c["reduced"] for c in BENCH["configs"] if c["name"] == CONFIG)
    for key in ("B", "drop_path_rate", "precision", "optimizer", "images",
                "weights", "parameters"):
        assert key in cfg["assumed"], key


def test_the_weights_load_into_the_port():
    cfg = _cfg()
    params = ADAPTER.state(torch.Generator().manual_seed(1), cfg, CPU)
    net = ADAPTER.model(cfg, params)
    assert set(dict(net.named_parameters())) == set(params)
    tables = [p for n, p in params.items() if n.endswith("rpb")]
    assert len(tables) == 7 and all(float(p.abs().max()) <= 0.02
                                    for p in tables)
    norms = [p for n, p in params.items() if n.endswith("norm1.weight")]
    assert norms and all(bool((p == 1).all()) for p in norms)


@pytest.mark.parametrize("size", [{}, dict(H=128, W=128, B=1)])
def test_work_counts_the_forward_s_linear_layers_and_convs(size):
    """work()'s dense operations (the infer count: the forward once) are
    what torch's flop counter counts in a forward of the port's DiNAT:
    its linear layers and convs; B5 and B9 run on the CPU as plain torch
    ops it does not count as matmuls."""
    cfg = _cfg(**size)
    gen = torch.Generator().manual_seed(2)
    c = ADAPTER.clip(gen, cfg, common.workload(CELL), CPU)
    net = ADAPTER.model(cfg, ADAPTER.state(gen, cfg, CPU))
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        net(c["images"])
    infer = ADAPTER.work(cfg, "infer")
    assert set(infer) == {"B5", "B9", "step"}
    dense = infer["step"] - infer["B5"][1] - infer["B9"][1]
    assert dense == counter.get_total_flops()
    train = ADAPTER.work(cfg, "train")
    assert set(train) == {"B5", "B6", "B9", "B10", "step"}
    assert train["step"] == 3 * dense + sum(
        train[k][1] for k in ("B5", "B6", "B9", "B10"))


def test_the_full_size_step_is_3_3_tflop():
    cfg = common.config(CONFIG)
    w = ADAPTER.work(cfg, "train")
    dense = (w["step"] - sum(w[k][1] for k in ("B5", "B6", "B9", "B10"))) \
        / 3
    assert ADAPTER.frames(cfg) == 128
    # dinat_tiny publishes 4.3 GMACs an image with its attention
    assert 8.0e9 < dense / 128 < 8.4e9


def _chip_smoke_counts(B, HD, F, n, k):
    """chip_smoke.py's B5/B6 bounds (its volume check) and its B9/B10
    bounds (sp_forward_bound and the B10 bound) as it computes them from
    the tensors of one attention layer: ps 1, every window cell in the
    frame, every (query, slot) of the unpadded map live; B9 and B10 on
    the padded map."""
    f32 = 4
    vid, ctr = B * HD * F * n * n, B * HD * n * n
    vol = ctr * k * k
    m = n + 1
    pvid, w = B * HD * F * m * m, B * HD * m * m * k * k
    live = vol
    return {
        # nb(vid0, vid1, ctr_h, ctr_w, d); valid * taps * F * FLOPS
        "B5": (f32 * (2 * vid + 2 * ctr + vol), vol * F),
        # nb(args[:5]) + nb(g_vid0, g_vid1, g_ctr_h, g_ctr_w)
        "B6": (f32 * (2 * vid + 2 * ctr + vol + 2 * vid + 2 * ctr),
               vol * F),
        # nb(vid, weights, flows, out); terms * F * 2 + out.numel()
        "B9": (f32 * (pvid + w + 3 * w + pvid), live * F * 2 + pvid),
        # nb(vid, weights, flows) + nb(g, g_vid, g_w);
        # terms * F * 4 + g.numel()
        "B10": (f32 * (pvid + 4 * w + pvid + pvid + w), live * F * 4 + pvid),
    }


def test_work_is_chip_smoke_s_count_at_one_layer():
    """One level of one layer: the adapter's B5, B6, B9 and B10 equal
    chip_smoke's counts at the layer's tensors, but for the operations a
    (query, cell, channel) of the int path's search (2 for B5 where
    chip_smoke's float path counts 10, 4 for B6 where it counts 26)."""
    cfg = _cfg(depths=[1], num_heads=[2], dilations=[[1]], B=3)
    n, HD, F, k = 96 // 4, 2, 4, 3
    got = ADAPTER.work(cfg, "train")
    want = _chip_smoke_counts(3, HD, F, n, k)
    for key in ("B9", "B10"):
        assert got[key] == want[key], key
    for key, per in (("B5", work_window.FLOPS_PER_TAP_INT["B5"]),
                     ("B6", work_window.FLOPS_PER_TAP_INT["B6"])):
        assert got[key] == (want[key][0], want[key][1] * per), key
    assert work_window.FLOPS_PER_TAP_INT == {"B5": 2, "B6": 4}
    # at the cell's own size the four bounds are a few ms a step
    full = ADAPTER.work(common.config(CONFIG), "train")
    ms = {key: work.bound_ms(*full[key]) for key in ("B5", "B6", "B9",
                                                     "B10")}
    assert all(by == "bytes" and 0.5 < t < 5 for t, by in ms.values()), ms


def _ctx(table, names):
    return dict(spans=spans.Spans(table, 2, names, 1000.), work={},
                mean_step_s=1.)


def test_the_glue_reader_sums_the_attention_span_and_the_spans_inside():
    read = common.reader("dinat_na_glue_ms").read
    table = {("stnls.dinat.na", "glue"): [6000., 10],
             ("stnls.dinat.na", "B5"): [9000., 2],
             ("stnls.search", "glue"): [200., 2],
             ("stnls.search.volume", "glue"): [1000., 4],
             ("stnls.agg.pool", "glue"): [400., 2],
             ("stnls.agg.pool", "B9"): [5000., 2],
             (None, "glue"): [7000., 3]}
    names = {"stnls.dinat.na", "stnls.search", "stnls.search.volume",
             "stnls.agg.pool"}
    assert math.isclose(read(_ctx(table, names)), 3.8)
    # a program without the attention's span (the parent) reads nothing
    assert read(_ctx(table, names - {"stnls.dinat.na"})) is None


def test_the_kernel_readers_and_the_mfu_reader():
    class Tr:
        def layer_ms_per_step(self, layer):
            return {"B5": 2., "B9": 4.}.get(layer)
    nbytes = 3.35e9                       # 1 ms at 3.35 TB/s
    ctx = dict(trace=Tr(), work={"B5": (nbytes, 0), "B6": (nbytes, 0),
                                 "B9": (2 * nbytes, 0)})
    assert common.reader("b5_roofline").read(ctx) == 50.
    assert common.reader("b9_roofline").read(ctx) == 50.
    assert common.reader("b6_roofline").read(ctx) is None   # no kernel ran
    assert common.reader("b10_roofline").read(ctx) is None  # no work
    read = common.reader("dinat_step_mfu").read
    assert read(dict(work={"step": 67e12}, mean_step_s=2.)) == 50.
    assert read(dict(work={}, mean_step_s=2.)) is None
    _, layer = common.cell_metrics(BENCH, CELL)
    assert {m["name"] for m in layer} == {
        "b5_roofline", "b6_roofline", "b9_roofline", "b10_roofline",
        "dinat_na_glue_ms", "dinat_step_mfu"}


def test_a_whole_run_on_the_cpu_is_correct():
    res = _run()
    assert res["correct"] and res["failed"] == 0
    assert set(res["compared"]) == {"out_err", "loss_err", "grad_err"}
    assert set(res["metrics"]) == {"frames_per_s", "step_p90_ms",
                                   "peak_mem_gb", "setup_s"}


def _broken(change):
    """common.adapter with the dinat224 step changed by `change`."""
    load = common.adapter

    def adapter(name, here=common.HERE):
        mod = load(name, here)
        make = mod.step

        def step(cfg, mode, params):
            one = make(cfg, mode, params)
            return lambda c: change(one, c)
        mod.step = step
        return mod
    return adapter


def _altered(step, c):
    out = dict(step(c))
    out["out"] = out["out"].clone()
    out["out"].view(-1)[7] += 0.05
    return out


def _half_the_batch(step, c):
    """The loss and the gradients over image 0 of a batch of two alone."""
    out = dict(step(c))
    first = step({k: v[:1] for k, v in c.items()})
    out["loss"], out["grads"] = first["loss"], first["grads"]
    return out


def _one_gradient_dropped(step, c):
    """The gradient of one attention layer's bias table zeroed."""
    out = dict(step(c))
    out["grads"] = dict(out["grads"])
    name = "levels.1.blocks.1.attn.rpb"
    out["grads"][name] = torch.zeros_like(out["grads"][name])
    return out


@pytest.mark.parametrize("change", [_altered, _half_the_batch,
                                    _one_gradient_dropped])
def test_a_broken_run_is_caught(change, monkeypatch):
    monkeypatch.setattr(common, "adapter", _broken(change))
    assert _run()["correct"] is False


def test_the_port_agrees_with_the_reference_and_the_control_does_not():
    limits = common.config(CONFIG)["limits"]
    (_, _, sound), (_, _, control) = calibrate.readings(
        torch, CELL, [5], [7], 2, CPU, size=DINAT_SMALL)
    assert set(sound) == set(limits)
    assert all(v <= limits[k] for k, v in sound.items()), sound
    assert all(v > limits[k] for k, v in control.items()), control
