"""Readings that the limits of `correct` are set from, for one cell.

    python3 bench_h100/calibrate.py --workload <cell> --seeds 1,2,...
        [--control-seeds 7,8,9] [--steps 3]

For each seed: the cell's clips and weights, `--steps` steps of the
port's step at the cell's own size, and the judgement of the last one
against the plain reference (the numbers run.py compares). For each
control seed: the control (the reference in the precision below the
configuration's, adapter.control) put in the program's place and judged
the same way. One JSON line per reading on standard output; the benchmark's
own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(torch, cell, seeds, control_seeds, steps, device, size=None,
             here=None):
    """Yield (kind, seed, numbers) for the program's seeds, then the
    control's."""
    from bench_h100 import common, inputs
    here = common.HERE if here is None else here
    bench = common.benchmark(here.parent)
    entry = next(w for w in bench["workloads"] if w["name"] == cell)
    traffic = common.workload(cell, here)
    cfg = dict(common.config(entry["config"], here), **(size or {}))
    adapter = common.adapter(entry["config"], here)
    mode = traffic["mode"]
    for kind, seed in [("program", s) for s in seeds] + \
            [("control", s) for s in control_seeds]:
        gen = inputs.generator(seed, device)
        clips = [adapter.clip(gen, cfg, traffic, device)
                 for _ in range(traffic["clips"])]
        state = adapter.state(gen, cfg, device)
        c = clips[(steps - 1) % len(clips)]
        if kind == "program":
            step = adapter.step(cfg, mode, state)
            for i in range(steps):
                out = None
                out = step(clips[i % len(clips)])
            del step
        else:
            out = adapter.control(c, cfg, mode, state)
        del clips
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.empty_cache()
        yield kind, seed, adapter.judge(c, out, cfg, mode, state)
        del out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not torch.cuda.is_available():
        sys.exit("calibrate: no CUDA device")
    device = torch.device("cuda", 0)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    t0 = time.perf_counter()
    for kind, seed, nums in readings(torch, args.workload, seeds, controls,
                                     args.steps, device):
        print(json.dumps(dict(cell=args.workload, kind=kind, seed=seed,
                              seconds=time.perf_counter() - t0, **nums)),
              flush=True)


if __name__ == "__main__":
    main()
