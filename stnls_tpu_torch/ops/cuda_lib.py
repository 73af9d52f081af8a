"""Build and load the port's hand-written CUDA kernels.

Every `.cu` file under stnls_tpu_torch/csrc/ is compiled by `nvcc` for
Hopper (`sm_90a`), one `nvcc` process per source, all started together,
and the objects are linked into ONE shared library with a plain C
interface, loaded with `ctypes`. The build runs at first use, from the
repository's sources only, into `build/stnls_tpu_torch/` at the
repository root; the library's file name carries a hash of the sources,
the shared headers (`*.cuh`) and the flags, so an edited source or header
is rebuilt. Nothing is built or imported when this module is imported.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "stnls_tpu_torch"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas",
                     "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures: every pointer and the stream as c_void_p
SIGNATURES = {
    "stnls_nls_topk_fwd": [_P] * 5 + [_I] * 19 + [_F, _F] + [_I] * 7 + [_P],
    "stnls_agg_gather_fwd": [_P] * 4 + [_I] * 15 + [_P],
    "stnls_nls_topk_bwd": [_P] * 10 + [_I] * 17 + [_P],
    "stnls_agg_gather_bwd": [_P] * 7 + [_I] * 15 + [_P],
    "stnls_nls_vol_fwd": [_P] * 5 + [_I] * 18 + [_F, _F] + [_I] * 5 + [_P],
    "stnls_nls_vol_bwd": [_P] * 9 + [_I] * 18 + [_F, _F] + [_I] * 4 + [_P],
    "stnls_agg_scatter_add_fwd": [_P] * 4 + [_I] * 18 + [_P],
    "stnls_agg_scatter_add_bwd": [_P] * 6 + [_I] * 20 + [_P],
    "stnls_agg_pool_fwd": [_P] * 4 + [_I] * 15 + [_P],
    "stnls_agg_pool_bwd": [_P] * 6 + [_I] * 16 + [_P],
    "stnls_nls_topk_compiled": [_I, _I],
    "stnls_nls_vol_compiled": [_I, _I],
}


class KernelLibrary:
    """The loaded library, with how it was obtained."""

    def __init__(self, path, cdll, built, log):
        self.path = path
        self.cdll = cdll
        self.built = built          # False when a cached build was loaded
        self.log = log              # nvcc's output (ptxas register report)

    def __getattr__(self, name):
        return getattr(self.cdll, name)


def _nvcc():
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home and (Path(cuda_home) / "bin" / "nvcc").exists():
        return str(Path(cuda_home) / "bin" / "nvcc")
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(found).exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest(sources):
    """Hash of the flags, the sources and every shared header."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _build(sources, out):
    """Compile each source in its own nvcc process, all at once, then link
    the objects into the shared library `out`. Returns nvcc's output."""
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in sources]
        logs = [Path(tmp) / f"{src.stem}.log" for src in sources]
        procs = []
        for src, obj, out_log in zip(sources, objs, logs):
            with open(out_log, "w") as fh:
                procs.append(subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                    stdout=fh, stderr=subprocess.STDOUT))
        for proc in procs:
            proc.wait()
        outs = [out_log.read_text() for out_log in logs]
        log = "".join(outs)
        for src, proc, text in zip(sources, procs, outs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name} "
                                   f"({proc.returncode}):\n{text}")
        lib = Path(tmp) / out.name
        link = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(lib),
                               *map(str, objs)], capture_output=True,
                              text=True)
        log += link.stdout + link.stderr
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stdout + link.stderr}")
        os.replace(lib, out)
    return log


@functools.cache
def load():
    """Build (if needed) and load the kernel library; cached per process."""
    sources = _sources()
    path = BUILD_DIR / f"libstnls_tpu_torch_{_digest(sources)}.so"
    built, log = False, ""
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        log = _build(sources, path)
        built = True
    cdll = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(cdll, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return KernelLibrary(path, cdll, built, log)


def check_launch(err, name):
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
