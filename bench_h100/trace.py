"""From torch.profiler traces of a few steps to what the per-layer
metrics read: the device operations with their layer, the idle gaps and
what the host was doing in each (`traced`: host ops and device activity),
and the device's busy time over the steps' span (`device_busy`: device
activity alone, so that the host runs as it does untraced).

A trace is exported as Chrome JSON into the run's TMPDIR, read and
deleted at once. A kernel is tied to the host op that launched it by its
launch's correlation id: the launch (a CUDA runtime event) lies inside
the host ops that were running on its thread.
"""

import json
import os
import tempfile
import time

from bench_h100.common import sync

# the port's kernels (stnls_tpu_torch/csrc) by their device names, as
# profile_step.PORT_KERNELS lists them (stnls_tpu_torch at PR 15)
PORT_KERNELS = {"B1": "nls_topk_kernel", "B2": "nls_topk_bwd_query_kernel",
                "B3": "agg_gather_fwd_pixel_kernel",
                "B4": "agg_gather_bwd_tile_kernel",
                "B5": "nls_vol_fwd_kernel", "B6": "nls_vol_bwd_kernel",
                "B7": "agg_scatter_add_fwd_kernel",
                "B8": "agg_scatter_add_bwd_tile_kernel",
                "B9": "agg_pool_fwd_row_kernel",
                "B10": "agg_pool_bwd_kernel"}
# host ops under which a kernel counts as a convolution's
CONV_OPS = ("aten::convolution", "aten::convolution_backward",
            "aten::_convolution", "aten::cudnn_convolution",
            "aten::cudnn_convolution_backward")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
STEP_MARK = "bench_h100_step"
NAME_CHARS = 120


def port_kernel(name):
    """"B1" ... "B10" for a device name of one of the port's kernels, else
    None."""
    for key, base in PORT_KERNELS.items():
        if name == base or f"{base}<" in name or f"{base}(" in name \
                or name.startswith(f"{base}_"):
            return key
    return None


class Trace:
    """The reduced trace of `steps` traced steps.

    ops: [(name, start_us, dur_us, layer)], layer one of the port's "B1"
    ... "B10", "conv" (launched under a convolution op) or "glue" (every
    other device operation); window: (start_us, end_us) of the traced
    steps on the host clock of the trace; busy_us: the union of the device
    operations' intervals inside the window; gaps: [(label, us)] the idle
    stretches inside the window, longest first, labelled with the
    innermost host op running on the launching thread at their middle."""

    def __init__(self, ops, steps, window, busy_us, gaps):
        self.ops, self.steps, self.window = ops, steps, window
        self.busy_us, self.gaps = busy_us, gaps

    @property
    def window_us(self):
        return self.window[1] - self.window[0]

    def layer_ms_per_step(self, layer):
        """Device ms a step of the operations of `layer`, or None where
        none ran."""
        durs = [d for _, _, d, lay in self.ops if lay == layer]
        return sum(durs) / 1e3 / self.steps if durs else None

    def top_ops(self, n=10):
        """The n device operations (by name) with the most time, in
        seconds over the traced window."""
        tot = {}
        for name, _, dur, _ in self.ops:
            key = name[:NAME_CHARS]
            tot[key] = tot.get(key, 0.) + dur / 1e6
        return sorted(tot.items(), key=lambda kv: -kv[1])[:n]


def _device_ops(events):
    """The Chrome trace's device operations (kernels, copies, fills)."""
    return [e for e in events if e.get("ph") == "X"
            and e.get("cat", "").lower() in DEVICE_CATS]


def busy_us(events):
    """The union of the device operations' intervals, in us."""
    return sum(e - s for s, e in _union(
        (e["ts"], e["ts"] + e["dur"]) for e in _device_ops(events)))


def _union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce_events(events):
    """A Trace from Chrome trace events."""
    xs = [e for e in events if e.get("ph") == "X"]
    marks = [e for e in xs if e.get("name") == STEP_MARK
             and e.get("cat", "").lower() == "user_annotation"]
    if not marks:
        raise RuntimeError("the trace holds no step marks")
    window = (min(e["ts"] for e in marks),
              max(e["ts"] + e["dur"] for e in marks))
    cpu = {}
    for e in xs:
        if e.get("cat", "").lower() in ("cpu_op", "user_annotation") \
                and e.get("name") != STEP_MARK:
            cpu.setdefault(e["tid"], []).append(e)
    launches = {e["args"]["correlation"]: e for e in xs
                if e.get("cat", "").lower() in LAUNCH_CATS
                and "correlation" in e.get("args", {})}
    conv = {tid: [(e["ts"], e["ts"] + e["dur"]) for e in evs
                  if e["name"] in CONV_OPS] for tid, evs in cpu.items()}
    ops = []
    for e in _device_ops(xs):
        s, d = e["ts"], e["dur"]
        if s + d <= window[0] or s >= window[1]:
            continue
        layer = port_kernel(e["name"])
        if layer is None:
            launch = launches.get(e.get("args", {}).get("correlation"))
            layer = "glue"
            if launch is not None and any(
                    a <= launch["ts"] <= b
                    for a, b in conv.get(launch["tid"], ())):
                layer = "conv"
        ops.append((e["name"], s, d, layer))
    merged = _union((max(s, window[0]), min(s + d, window[1]))
                    for _, s, d, _ in ops)
    busy = sum(e - s for s, e in merged)
    edges = [window[0]] + [x for iv in merged for x in iv] + [window[1]]
    holes = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
             if edges[i + 1] > edges[i]]
    holes.sort(key=lambda h: h[0] - h[1])
    gaps = [(_host_label(cpu, (a + b) / 2), b - a) for a, b in holes[:10]]
    return Trace(ops, len(marks), window, busy, gaps)


def _host_label(cpu, t):
    """The innermost host op running at time t on any thread (the
    shortest that contains t), or "host idle"."""
    best = None
    for evs in cpu.values():
        for e in evs:
            if e["ts"] <= t <= e["ts"] + e["dur"] and (
                    best is None or e["dur"] < best["dur"]):
                best = e
    return best["name"][:NAME_CHARS] if best else "host idle"


def _events(prof):
    """The Chrome trace events of a finished profile."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            return json.load(fh)["traceEvents"]
    finally:
        os.unlink(path)


def traced(torch, run_step, steps, device):
    """Run `run_step` (which ends in a synchronize) steps + 1 times under
    torch.profiler, the first as the profiler's warm-up, each traced step
    inside a STEP_MARK range. Returns a Trace."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        run_step(0)
        sync(torch, device)
        for i in range(steps):
            with record_function(STEP_MARK):
                run_step(i + 1)
                sync(torch, device)
    return reduce_events(_events(prof))


def device_busy(torch, run_step, steps, device):
    """(busy_us, window_us) of `steps` closed-loop steps under a profiler
    that records the device's activity alone: the union of the device
    operations' intervals, and the steps' span on the host clock from a
    synchronized device to the last step's synchronize. Every device
    operation in the trace belongs to these steps. None off CUDA."""
    if device.type != "cuda":
        return None
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sync(torch, device)
        t0 = time.perf_counter()
        for i in range(steps):
            run_step(i)
            sync(torch, device)
        t1 = time.perf_counter()
    return busy_us(_events(prof)), (t1 - t0) * 1e6
