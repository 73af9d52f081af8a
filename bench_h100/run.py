"""Run one cell of the H100 benchmark of stnls_tpu_torch and print one
JSON line.

    python3 bench_h100/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks
for. In order: TF32 off; the cell's clips (and weights) made on the card
from the seed; the port's kernel library loaded from (or built into) the
checkout's build/stnls_tpu_torch/; warm-up steps on the cell's own
shapes; the measured window, one closed-loop step after another (each
ends in torch.cuda.synchronize) for `--seconds`; with --trace 1, a few
more steps under torch.profiler with host ops (for the layers and the
idle gaps' labels), then more recording the device alone (for its busy
time); then the window's last step is judged
against the plain reference (reference/<config>.py). The last line of
standard output is the result; the numbers compared, each beside its
limit, are the last lines of standard error.

Exits non-zero without printing a result when no card (or fewer than the
cell asks for) is present, or when JAX, flax or the JAX package
(stnls_tpu) is loaded after set-up, after the window or before the
result is printed.
"""

import time

START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def log(msg):
    print(f"bench_h100: {msg}", file=sys.stderr, flush=True)


def p90(values):
    """The 90th percentile, nearest rank."""
    xs = sorted(values)
    return xs[max(0, math.ceil(0.9 * len(xs)) - 1)]


def power_limit():
    """The card's name and power limit by nvidia-smi, or None."""
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = smi.stdout.strip().splitlines()
    return lines[0].strip() if smi.returncode == 0 and lines else None


def load_library(torch, device):
    """Load the port's kernel library (building it into the checkout the
    first time) and say which it was."""
    if device.type != "cuda":
        return
    from stnls_tpu_torch.ops import cuda_lib
    t0 = time.perf_counter()
    lib = cuda_lib.load()
    how = "built" if lib.built else "loaded from the build cache"
    log(f"kernel library {how} in {time.perf_counter() - t0:.3f} s: "
        f"{lib.path}")


def run_cell(torch, bench, cell, seed, seconds, trace, device, size=None,
             here=None):
    """Run the cell on `device` and return the result line's object.
    `size` replaces entries of the configuration (tests at small sizes;
    here is the folder of the benchmark's files)."""
    from bench_h100 import common, inputs
    from bench_h100 import trace as trace_mod
    here = common.HERE if here is None else here
    entry = next(w for w in bench["workloads"] if w["name"] == cell)
    traffic = common.workload(cell, here)
    cfg = dict(common.config(entry["config"], here), **(size or {}))
    adapter = common.adapter(entry["config"], here)
    mode = traffic["mode"]
    cuda = device.type == "cuda"

    gen = inputs.generator(seed, device)
    clips = [adapter.clip(gen, cfg, traffic, device)
             for _ in range(traffic["clips"])]
    state = adapter.state(gen, cfg, device)
    load_library(torch, device)
    step = adapter.step(cfg, mode, state)
    out = None
    for i in range(traffic["warmup_steps"]):
        out = None
        out = step(clips[i % len(clips)])
        common.sync(torch, device)
    common.require_no_jax("after set-up")
    setup_s = time.perf_counter() - START
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    # the measured window
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    times = []
    i = 0
    t_start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        out = None
        out = step(clips[i % len(clips)])
        common.sync(torch, device)
        t1 = time.perf_counter()
        times.append(t1 - t0)
        i += 1
        if t1 - t_start >= seconds:
            break
    window_s = t1 - t_start
    last_clip = clips[(i - 1) % len(clips)]
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    common.require_no_jax("after the window")
    T = adapter.frames(cfg)
    e2e = {"frames_per_s": len(times) * T / window_s,
           "step_p90_ms": p90(times) * 1e3,
           "peak_mem_gb": window_peak / 1e9,
           "setup_s": setup_s}
    log(f"window: {len(times)} steps in {window_s:.3f} s, set-up "
        f"{setup_s:.3f} s")

    tr = busy = None
    if trace:
        n = traffic["trace_steps"]

        def traced_step(j):
            adapter_out = step(clips[j % len(clips)])
            del adapter_out
        t0 = time.perf_counter()
        m = traffic["busy_steps"]
        tr = trace_mod.traced(torch, traced_step, n, device)
        busy = trace_mod.device_busy(torch, traced_step, m, device)
        log(f"traced {n} + {m} steps in {time.perf_counter() - t0:.3f} s")
    del step, clips
    if cuda:
        torch.cuda.empty_cache()

    # the judgement, after the window, of its last step
    t0 = time.perf_counter()
    nums = adapter.judge(last_clip, out, cfg, mode, state)
    del out
    log(f"judged the window's last step in {time.perf_counter() - t0:.3f} "
        "s")
    limits = cfg["limits"]
    compared = {k: {"value": v, "limit": limits[k]} for k, v in nums.items()}
    correct = all(math.isfinite(v) and v <= limits[k]
                  for k, v in nums.items())

    e2e_ms, layer_ms = common.cell_metrics(bench, cell)
    metrics = {}
    if not trace:
        for m in e2e_ms:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    else:
        ctx = dict(trace=tr, busy=busy, work=adapter.work(cfg, mode),
                   mean_step_s=window_s / len(times), cfg=cfg, mode=mode)
        for m in layer_ms:
            value = common.reader(m["name"], here).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": entry["chips"],
           "memory_peak_bytes": max(setup_peak, window_peak)}
    if cuda:
        dev["power_limit"] = power_limit()
    result = {"correct": correct, "attempted": len(times),
              "failed": 0 if correct else 1, "metrics": metrics,
              "device": dev}
    if busy is not None:
        dev["busy_s"] = busy[0] / 1e6
        dev["window_s"] = busy[1] / 1e6
    if tr is not None:
        result["breakdown"] = {
            "device_ops": [[k, v] for k, v in tr.top_ops(10)],
            "idle_gaps": [[k, v / 1e6] for k, v in tr.gaps]}
    result["compared"] = compared
    return result


def report(result):
    """Print the numbers compared, each beside its limit, as the last lines
    of standard error, then the result line, once nothing of JAX is
    loaded (else exit without a result)."""
    from bench_h100 import common
    for name, c in result["compared"].items():
        log(f"compared {name} {c['value']!r} limit {c['limit']!r}")
    log(f"correct {result['correct']}")
    common.require_no_jax("before the result")
    print(json.dumps(result), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, str(ROOT))
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from bench_h100 import common
    bench = common.benchmark(ROOT)
    entry = next((w for w in bench["workloads"]
                  if w["name"] == args.workload), None)
    if entry is None:
        sys.exit(f"bench_h100: no cell {args.workload!r} in BENCHMARK.json")
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < entry["chips"]:
        sys.exit(f"bench_h100: the cell needs {entry['chips']} CUDA "
                 f"device(s); {torch.cuda.device_count()} available")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    report(run_cell(torch, bench, args.workload, args.seed, args.seconds,
                    args.trace, device))


if __name__ == "__main__":
    main()
