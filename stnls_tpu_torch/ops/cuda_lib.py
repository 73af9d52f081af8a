"""Build and load the port's hand-written CUDA kernels.

Every `.cu` file under stnls_tpu_torch/csrc/ is compiled by `nvcc` for
Hopper (`sm_90a`) into ONE shared library with a plain C interface, loaded
with `ctypes`. The build runs at first use, from the repository's sources
only, into `build/stnls_tpu_torch/` at the repository root; the library's
file name carries a hash of the sources and flags, so an edited source is
rebuilt. Nothing is built or imported when this module is imported.
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
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures: every pointer and the stream as c_void_p
SIGNATURES = {
    "stnls_nls_topk_fwd": [_P] * 5 + [_I] * 15 + [_F, _F] + [_I] * 6 + [_P],
    "stnls_agg_gather_fwd": [_P] * 4 + [_I] * 15 + [_P],
    "stnls_nls_topk_bwd": [_P] * 10 + [_I] * 15 + [_P],
    "stnls_agg_gather_bwd": [_P] * 7 + [_I] * 15 + [_P],
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
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


@functools.cache
def load():
    """Build (if needed) and load the kernel library; cached per process."""
    sources = _sources()
    path = BUILD_DIR / f"libstnls_tpu_torch_{_digest(sources)}.so"
    built, log = False, ""
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        os.replace(tmp, path)
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
