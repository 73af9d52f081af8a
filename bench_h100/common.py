"""Finding the benchmark's pieces by name, and the checks every run
makes: names, the device, and that nothing of JAX is loaded."""

import importlib.util
import json
import re
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
# top-level module names that may not be loaded in a run
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "stnls_tpu")


def benchmark(root=ROOT):
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _by_name(folder, name, suffix):
    if not NAME.match(name):
        raise ValueError(f"bad name {name!r}")
    path = Path(folder) / f"{name}{suffix}"
    if not path.is_file():
        raise FileNotFoundError(f"{path} not found")
    return path


def workload(name, here=HERE):
    """A cell's traffic: workloads/<cell>.json."""
    return json.loads(_by_name(Path(here) / "workloads", name,
                               ".json").read_text())


def config(name, here=HERE):
    """A configuration's sizes: configs/<config>.json."""
    return json.loads(_by_name(Path(here) / "configs", name,
                               ".json").read_text())


def load_module(path, label):
    spec = importlib.util.spec_from_file_location(label, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def adapter(name, here=HERE):
    """A configuration's adapter: configs/<config>.py."""
    return load_module(_by_name(Path(here) / "configs", name, ".py"),
                       f"bench_h100_config_{name}")


def reader(name, here=HERE):
    """A per-layer metric's reader: metrics/<metric>.py, whose read(ctx)
    returns its value, or None where it finds nothing to read."""
    return load_module(_by_name(Path(here) / "metrics", name, ".py"),
                       f"bench_h100_metric_{name}")


def reference(name, here=HERE):
    """A configuration's plain reference: reference/<config>.py."""
    return load_module(_by_name(Path(here) / "reference", name, ".py"),
                       f"bench_h100_reference_{name}")


def listed(folder, suffix, here=HERE):
    """The names of the files of one kind, as found on disk."""
    return sorted(p.name[:-len(suffix)] for p in
                  (Path(here) / folder).glob(f"*{suffix}")
                  if not p.name.startswith("_"))


def cell_metrics(bench, cell):
    """(end-to-end, per-layer) metric entries that `cell` reports."""
    def takes(m):
        return "workloads" not in m or cell in m["workloads"]
    return ([m for m in bench["end_to_end"] if takes(m)],
            [m for m in bench["per_layer"] if takes(m)])


def forbidden_loaded(modules=None):
    """The loaded modules whose top-level name (before the first dot) is
    one of FORBIDDEN_MODULES, compared whole."""
    modules = sys.modules if modules is None else modules
    return sorted({name for name in modules
                   if name.split(".", 1)[0] in FORBIDDEN_MODULES})


def require_no_jax(when):
    """Exit (no result) if JAX, flax or the JAX package is loaded."""
    found = forbidden_loaded()
    if found:
        print(f"bench_h100: {when}: forbidden modules loaded: "
              f"{', '.join(found)}", file=sys.stderr, flush=True)
        sys.exit(4)


def sync(torch, device):
    """Wait for the device (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
