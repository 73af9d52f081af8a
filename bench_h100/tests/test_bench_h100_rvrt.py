"""The rvrt256 configuration on the CPU at a tiny size: the adapter's
weights load into the port's RVRT, its work counts the operations the
model runs, its readers read the spans they name, a whole run is correct,
and a run broken underneath (an altered answer, half the batch left out
of the loss, the reference in TF32) is not."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from _small import BENCH, SIZES
from bench_h100 import calibrate, common, spans
from bench_h100.run import run_cell

CELL, CONFIG = "rvrt256.train", "rvrt256"
ADAPTER = common.adapter(CONFIG)
CPU = torch.device("cpu")


def _cfg(**size):
    return dict(common.config(CONFIG), **dict(SIZES[CONFIG], **size))


def _run(seed=2 ** 31 + 99, **size):
    return run_cell(torch, BENCH, CELL, seed, 0.05, 0, CPU,
                    size=dict(SIZES[CONFIG], **size))


def test_the_weights_load_into_the_port_and_the_step_counts_its_work():
    cfg = _cfg()
    params = ADAPTER.state(torch.Generator().manual_seed(1), cfg, CPU)
    net = ADAPTER.model(cfg, params)
    assert set(dict(net.named_parameters())) == set(params)
    norms = [p for n, p in params.items() if n.endswith("norm1.weight")]
    assert norms and all(bool((p == 1).all()) for p in norms)
    tables = [p for n, p in params.items() if n.endswith("bias_table")]
    assert all(float(p.abs().max()) <= 0.02 for p in tables)


@pytest.mark.parametrize("size", [{}, dict(H=40, W=40)])
def test_work_counts_the_forward_s_matmuls_and_convs(size):
    """work()'s dense operations (the infer count: the forward once) are
    what torch's flop counter counts in a forward of the port's RVRT:
    its linear layers, attention matmuls and convs, padded windows
    included; B1-B4 run on the CPU as plain torch ops it does not count
    as matmuls."""
    cfg = _cfg(**size)
    gen = torch.Generator().manual_seed(2)
    traffic = common.workload(CELL)
    clip = ADAPTER.clip(gen, cfg, traffic, CPU)
    net = ADAPTER.model(cfg, ADAPTER.state(gen, cfg, CPU))
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        net(clip["lq"], clip["fflow"], clip["bflow"])
    work = ADAPTER.work(cfg, "infer")
    dense = work["step"] - work["B1"][1] - work["B3"][1]
    assert dense == counter.get_total_flops()
    train = ADAPTER.work(cfg, "train")
    assert set(train) == {"B1", "B2", "B3", "B4", "step"}
    assert train["step"] == 3 * dense + sum(
        train[k][1] for k in ("B1", "B2", "B3", "B4"))


def test_the_full_size_step_is_16_frames_of_111_gflop():
    cfg = common.config(CONFIG)
    work = ADAPTER.work(cfg, "train")
    dense = (work["step"] - sum(work[k][1] for k in ("B1", "B2", "B3",
                                                     "B4"))) / 3
    assert ADAPTER.frames(cfg) == 32
    assert 105e9 < dense / 32 < 115e9


def _ctx(table, names):
    return dict(spans=spans.Spans(table, 2, names, 1000.), work={},
                mean_step_s=1.)


@pytest.mark.parametrize("metric,span", [
    ("rvrt_swin_ms", "stnls.rvrt.swin"),
    ("rvrt_align_ms", "stnls.rvrt.align"),
    ("rvrt_flow_ms", "stnls.rvrt.flow")])
def test_the_span_readers_read_their_own_span_s_glue(metric, span):
    read = common.reader(metric).read
    table = {(span, "glue"): [6000., 10], (span, "B1"): [9000., 2],
             ("stnls.search.select", "glue"): [500., 1]}
    assert read(_ctx(table, {span, "stnls.search.select"})) == 3.
    # a program without the span (the parent) reads nothing
    assert read(_ctx(table, {"stnls.search.select"})) is None


def test_the_mfu_reader_and_its_listing():
    read = common.reader("rvrt_step_mfu").read
    assert read(dict(work={"step": 67e12}, mean_step_s=2.)) == 50.
    assert read(dict(work={}, mean_step_s=2.)) is None
    _, layer = common.cell_metrics(BENCH, CELL)
    assert {m["name"] for m in layer} == {
        "rvrt_swin_ms", "rvrt_align_ms", "rvrt_flow_ms", "rvrt_step_mfu"}


def test_a_whole_run_on_the_cpu_is_correct():
    res = _run()
    assert res["correct"] and res["failed"] == 0
    assert set(res["compared"]) == {"out_err", "loss_err", "grad_err",
                                    "dists_err", "inds_err", "flow_err"}
    assert set(res["metrics"]) == {"frames_per_s", "step_p90_ms",
                                   "peak_mem_gb", "setup_s"}


def _broken(change):
    """common.adapter with the rvrt256 step changed by `change`."""
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
    out["out"] = out["out"].clone(memory_format=torch.contiguous_format)
    out["out"].view(-1)[7] += 0.05
    return out


def _half_the_batch(step, c):
    """The loss and the gradients over clip 0 of a batch of two alone."""
    out = dict(step(c))
    first = step({k: v[:1] for k, v in c.items()})
    out["loss"], out["grads"] = first["loss"], first["grads"]
    return out


def _moved_offsets(step, c):
    out = dict(step(c))
    sel = dict(out["align"][-1])
    sel["dists"] = sel["dists"].clone(memory_format=torch.contiguous_format)
    sel["dists"].view(-1)[3] += 0.01
    out["align"] = out["align"][:-1] + [sel]
    return out


def _moved_flows(step, c):
    """A flow that centred the last search moved by a hundredth of a
    pixel (its selection left as it was)."""
    out = dict(step(c))
    sel = dict(out["align"][-1])
    sel["flows"] = sel["flows"].clone(memory_format=torch.contiguous_format)
    sel["flows"].view(-1)[5] += 0.01
    out["align"] = out["align"][:-1] + [sel]
    return out


@pytest.mark.parametrize("change", [_altered, _half_the_batch,
                                    _moved_offsets, _moved_flows])
def test_a_broken_run_is_caught(change, monkeypatch):
    monkeypatch.setattr(common, "adapter", _broken(change))
    # two clips a step, so that clip 0 alone is half the batch
    size = dict(B=2) if change is _half_the_batch else {}
    assert _run(**size)["correct"] is False


def test_the_port_agrees_with_the_reference_and_the_control_does_not():
    limits = common.config(CONFIG)["limits"]
    readings = list(calibrate.readings(torch, CELL, [5], [7], 2, CPU,
                                       size=SIZES[CONFIG]))
    (_, _, sound), (_, _, control) = readings
    assert set(sound) == set(limits)
    assert all(v <= limits[k] for k, v in sound.items()), sound
    assert any(v > limits[k] for k, v in control.items()), control
