"""Credit each device operation of a traced window to the program's span
that launched it, forward or backward.

The program opens torch.profiler ranges named stnls.<layer>.<stage> at
its layers' boundaries (stnls_tpu_torch/utils/spans.py). A device
operation is tied to its launch (a CUDA runtime event) by correlation id,
as trace.py ties a kernel to a convolution. Then, on the launching
thread:
  - forward: the innermost stnls.* range around the launch takes it;
  - autograd's backward: where the launch lies inside an
    `autograd::engine::evaluate_function: ...` op, and no stnls.* range
    opened inside that op (the program's .bwd spans) is nearer, the op's
    sequence number names the forward op that made the autograd node: the
    last forward op recorded with that number, since the counter steps
    when a node is made. The innermost stnls.* range around that forward
    op, on its thread, takes it.
An operation no stnls.* range takes is "unspanned" (None). The layers
are trace.py's (B1 ... B10, conv, glue), taken from trace.reduce_events
on the same events, so that the glue entries of all spans and None
partition torch_glue_ms's reading of that trace exactly.

The harness reduces its trace before the readers run and keeps no
events, so the readers of these metrics take a traced pass of their own:
`trace_steps` more steps of the same cell, after its warm-up steps, on
clips from a fixed seed (`of_run`, once a run).
"""

import sys

from bench_h100 import common, inputs, trace

PREFIX = "stnls."
EVALUATE = "autograd::engine::evaluate_function"
SEED = 0


class Spans:
    """table: {(span or None, layer): [device us, launches]} over `steps`
    traced steps; names: the stnls.* spans open in the window; window_us:
    the traced steps' span on the trace's host clock."""

    def __init__(self, table, steps, names, window_us):
        self.table, self.steps = table, steps
        self.names, self.window_us = names, window_us

    def ms(self, span, layer="glue"):
        """Device ms a step of `layer`'s operations credited to `span`
        (None: to no span); None where the window ran no device
        operation, or the program opened no such span (no stnls.* span at
        all, for None)."""
        if not self.table or not (self.names if span is None
                                  else span in self.names):
            return None
        return self.table.get((span, layer), (0., 0))[0] / 1e3 / self.steps

    def rows(self):
        """[(span, layer, ms a step, launches a step)], most time first."""
        return sorted(((s, lay, us / 1e3 / self.steps, n / self.steps)
                       for (s, lay), (us, n) in self.table.items()),
                      key=lambda r: -r[2])


def _innermost(ranges, points):
    """For each (tid, t) of `points`, the innermost event of `ranges`
    (properly nested on each thread) on that thread whose interval holds
    t, or None."""
    by_tid = {}
    for e in ranges:
        by_tid.setdefault(e["tid"], []).append(e)
    found = [None] * len(points)
    queries = {}
    for i in sorted(range(len(points)), key=lambda i: points[i][1]):
        queries.setdefault(points[i][0], []).append(i)
    for tid, idxs in queries.items():
        evs = sorted(by_tid.get(tid, ()), key=lambda e: (e["ts"], -e["dur"]))
        stack, j = [], 0
        for i in idxs:
            t = points[i][1]
            while j < len(evs) and evs[j]["ts"] <= t:
                while stack and stack[-1]["ts"] + stack[-1]["dur"] < \
                        evs[j]["ts"]:
                    stack.pop()
                stack.append(evs[j])
                j += 1
            while stack and stack[-1]["ts"] + stack[-1]["dur"] < t:
                stack.pop()
            found[i] = stack[-1] if stack else None
    return found


def _cat(e):
    return e.get("cat", "").lower()


def credit(events):
    """The Spans of a Chrome trace's events (trace.traced's window)."""
    tr = trace.reduce_events(events)
    xs = [e for e in events if e.get("ph") == "X"]
    w0, w1 = tr.window
    dev = [e for e in trace._device_ops(xs)
           if not (e["ts"] + e["dur"] <= w0 or e["ts"] >= w1)]
    if [e["name"] for e in dev] != [op[0] for op in tr.ops]:
        raise RuntimeError("spans: the window's device operations differ "
                           "from trace.reduce_events'")
    spans = [e for e in xs if _cat(e) == "user_annotation"
             and e["name"].startswith(PREFIX)]
    evals = [e for e in xs if _cat(e) == "cpu_op"
             and e["name"].startswith(EVALUATE)]
    launches = {e["args"]["correlation"]: e for e in xs
                if _cat(e) in trace.LAUNCH_CATS
                and "correlation" in e.get("args", {})}

    # the forward op that made each autograd node, by sequence number
    seq_ops = [e for e in xs if _cat(e) == "cpu_op"
               and "Sequence number" in e.get("args", {})
               and not e["name"].startswith(EVALUATE)]
    inside = _innermost(evals, [(e["tid"], e["ts"]) for e in seq_ops])
    maker = {}
    for e, ev in sorted(zip(seq_ops, inside), key=lambda p: p[0]["ts"]):
        if ev is None:
            maker[e["args"]["Sequence number"]] = e
    makers = list(maker.values())
    maker_span = dict(zip((id(e) for e in makers), _innermost(
        spans, [(e["tid"], e["ts"]) for e in makers])))

    ops = [(e, launches.get(e.get("args", {}).get("correlation")))
           for e in dev]
    points = [(la["tid"], la["ts"]) if la else (None, 0.) for _, la in ops]
    around = _innermost(spans, points)
    node = _innermost(evals, points)
    table = {}
    for (e, la), (_, _, d, layer), sp, ev in zip(ops, tr.ops, around, node):
        if la is not None and ev is not None and (
                sp is None or sp["ts"] < ev["ts"]):
            fwd = maker.get(ev.get("args", {}).get("Sequence number"))
            sp = maker_span[id(fwd)] if fwd is not None else None
        key = (sp["name"] if sp else None, layer)
        acc = table.setdefault(key, [0., 0])
        acc[0] += d
        acc[1] += 1
    names = {e["name"] for e in spans
             if not (e["ts"] + e["dur"] <= w0 or e["ts"] >= w1)}
    return Spans(table, tr.steps, names, tr.window_us)


def traced_events(torch, run_step, steps, device):
    """The Chrome trace events of `steps` steps traced as trace.traced
    traces them: a profiler warm-up step, then each step inside a
    STEP_MARK range."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        run_step(0)
        common.sync(torch, device)
        for i in range(steps):
            with record_function(trace.STEP_MARK):
                run_step(i + 1)
                common.sync(torch, device)
    return trace._events(prof)


def of_run(ctx):
    """The Spans of the run's cell, from a traced pass of the readers'
    own, made once a run and kept in the run's ctx: the cell's clips and
    state from SEED, its warm-up steps, then its `trace_steps` steps
    traced."""
    if "spans" not in ctx:
        ctx["spans"] = _measure(ctx["cfg"], ctx["mode"], ctx["mean_step_s"])
    return ctx["spans"]


def glue_ms(ctx, span):
    """Device ms a step of the glue credited to `span` (None: to no
    span), or None (Spans.ms)."""
    return of_run(ctx).ms(span)


def _measure(cfg, mode, mean_step_s):
    import torch
    bench = common.benchmark()
    cell = next(w["name"] for w in bench["workloads"]
                if w["config"] == cfg["name"] and w["traffic"] == mode)
    traffic = common.workload(cell)
    adapter = common.adapter(cfg["name"])
    device = torch.device("cuda", torch.cuda.current_device()) \
        if torch.cuda.is_available() else torch.device("cpu")
    gen = inputs.generator(SEED, device)
    clips = [adapter.clip(gen, cfg, traffic, device)
             for _ in range(traffic["clips"])]
    step = adapter.step(cfg, mode, adapter.state(gen, cfg, device))

    def run_step(j):
        step(clips[j % len(clips)])
    for j in range(traffic["warmup_steps"]):
        run_step(j)
    common.sync(torch, device)
    events = traced_events(torch, run_step, traffic["trace_steps"], device)
    del step, clips
    if device.type == "cuda":
        torch.cuda.empty_cache()
    res = credit(events)
    _log(res, mean_step_s)
    return res


def _log(res, mean_step_s):
    glue = sum(us for (_, lay), (us, _) in res.table.items()
               if lay == "glue") / 1e3 / res.steps
    traced_ms = res.window_us / 1e3 / res.steps
    lines = [f"spans: {res.steps} traced steps, {traced_ms:.3f} ms a step "
             f"traced, {traced_ms / 1e3 / mean_step_s:.4f} x the window's "
             f"mean step; glue {glue:.3f} ms a step"]
    lines += [f"spans: {s or '(unspanned)'} {lay} {ms:.3f} ms "
              f"x{n:.0f} a step" for s, lay, ms, n in res.rows()]
    for line in lines:
        print(f"bench_h100: {line}", file=sys.stderr, flush=True)
