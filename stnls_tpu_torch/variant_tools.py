"""What the variants scripts (b1_variants, b2_b3_variants, b5_b6_variants,
b8_b9_variants, b7_b10_variants) share: a kernel source, changed by text
substitutions, built alone into a library of its own; the shipped library
with one entry taken from such a library; pointing the wrappers at a
library; the card's name and power limit; the device time of a call
(torch.profiler); a library's SASS and register use (cuobjdump). Nothing
is built or loaded when this module is imported.
"""

import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path


def card():
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return smi.stdout.strip()


def build(cuda_lib, src, out_dir, name, subs=(), include=None):
    """`src`, with the text substitutions `subs` (old, new), built alone
    into out_dir/lib<name>.so with the shipped flags, its headers from
    `include` (default the shipped csrc/); returns (path, nvcc's output).
    Exits where a substitution no longer applies or nvcc fails."""
    text = Path(src).read_text()
    for old, new in subs:
        if old not in text:
            sys.exit(f"variant {name}: {src} no longer has {old!r}")
        text = text.replace(old, new)
    out = Path(out_dir) / f"{name}.cu"
    out.write_text(text)
    lib = Path(out_dir) / f"lib{name}.so"
    r = subprocess.run([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-shared",
                        "-I", str(include or cuda_lib.CSRC), "-o", str(lib),
                        str(out)], capture_output=True, text=True)
    if r.returncode:
        sys.exit(f"variant {name} failed to build:\n{r.stdout}{r.stderr}")
    return lib, r.stdout + r.stderr


def ptxas_lines(log, only=None):
    """The register and spill lines of ptxas's report, with the entry
    function each follows; `only`, a substring, keeps the entries whose
    mangled name holds it."""
    return "\n".join(line.strip() for line in log.splitlines()
                     if ("registers" in line or "spill" in line or
                         "entry function" in line) and
                     (only is None or only in line or
                      "entry function" not in line))


def ptxas_table(log, name):
    """One line per instantiation of the kernel `name` in ptxas's report:
    its template arguments, registers, stack frame and spills."""
    rows, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            mangled = m.group(1)
            cur = None
            if name in mangled:
                args = re.findall(r"L([ib])(\d+)E", mangled.split(name)[1])
                cur = [f"{name}<" + ", ".join(
                    v if t == "i" else ("false", "true")[int(v)]
                    for t, v in args) + ">"]
                rows.append(cur)
        elif cur is not None and ("stack frame" in line or
                                  "registers" in line):
            cur.append(line.split(":")[-1].strip())
            if "registers" in line:
                cur = None
    return "\n".join(": ".join(r) for r in rows)


class Variant:
    """The shipped library with the entry `sym` taken from the library at
    `path`, its C signature `argtypes` (default the shipped entry's);
    `adapt`, when given, maps the shipped call's arguments to the
    variant's."""

    def __init__(self, shipped, path, sym, argtypes=None, adapt=None):
        from stnls_tpu_torch.ops import cuda_lib
        fn = getattr(ctypes.CDLL(str(path)), sym)
        fn.argtypes = argtypes or cuda_lib.SIGNATURES[sym]
        fn.restype = ctypes.c_int
        self._shipped, self._sym = shipped, sym
        self._fn = fn if adapt is None else lambda *a: fn(*adapt(a))

    def __getattr__(self, name):
        return self._fn if name == self._sym else getattr(self._shipped,
                                                          name)


def swap(cuda_lib, lib):
    """Point every wrapper at `lib` (the shipped library or a Variant)."""
    cuda_lib.load = lambda: lib


def device_ms(torch, fn, n=10):
    """Device time of one call of fn: the sum of the device times of the
    kernels, copies and memsets it launched, torch.profiler over n calls."""
    from torch.profiler import profile, ProfilerActivity
    from torch.autograd import DeviceType
    for _ in range(3):              # a session can come back empty: again
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        total = sum(getattr(r, "self_device_time_total",
                            getattr(r, "self_cuda_time_total", 0.))
                    for r in prof.key_averages()
                    if r.device_type == DeviceType.CUDA)
        if total > 0:
            break
    return total / 1e3 / n


def sass(lib_path, names):
    """{kernel name: its SASS text, addresses and all} of the kernels of
    `names` in a library, by cuobjdump; None without cuobjdump."""
    from stnls_tpu_torch.ops import cuda_lib
    tool = Path(cuda_lib._nvcc()).with_name("cuobjdump")
    if not tool.exists() and not shutil.which("cuobjdump"):
        return None
    r = subprocess.run([str(tool) if tool.exists() else "cuobjdump",
                        "-sass", str(lib_path)], capture_output=True,
                       text=True)
    out, cur = {}, None
    for line in r.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = next((n for n in names if n in m.group(1)), None)
            if cur:
                out[cur] = []
            continue
        if cur and line.strip().startswith("....."):   # the function's end
            cur = None
        if cur:
            out[cur].append(line.strip())
    return {k: "\n".join(v) for k, v in out.items()}


def res_usage(lib_path, names):
    """cuobjdump's resource usage lines (registers, shared memory) of the
    kernels of `names` in a library."""
    from stnls_tpu_torch.ops import cuda_lib
    tool = Path(cuda_lib._nvcc()).with_name("cuobjdump")
    r = subprocess.run([str(tool) if tool.exists() else "cuobjdump",
                        "-res-usage", str(lib_path)], capture_output=True,
                       text=True)
    lines, keep = [], False
    for line in r.stdout.splitlines():
        if "Function" in line:
            keep = any(n in line for n in names)
            if keep:
                lines.append(line.strip()[-80:])
        elif keep and "REG" in line:
            lines.append("  " + line.strip())
    return "\n".join(lines)
