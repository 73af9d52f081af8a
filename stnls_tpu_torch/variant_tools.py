"""What the variants scripts (b1_variants, b2_b3_variants, b5_b6_variants)
share: a kernel source, changed by text substitutions, built alone into a
library of its own; the shipped library with one entry taken from such a
library; pointing the wrappers at a library; the card's name and power
limit. Nothing is built or loaded when this module is imported.
"""

import ctypes
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
