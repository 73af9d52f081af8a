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

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "stnls_tpu_torch"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas",
                     "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures: every pointer and the stream as c_void_p
SIGNATURES = {
    "stnls_nls_topk_fwd": [_P] * 6 + [_I] * 19 + [_F, _F] + [_I] * 7 + [_P],
    "stnls_agg_gather_fwd": [_P] * 4 + [_I] * 17 + [_P],
    "stnls_nls_topk_bwd": [_P] * 11 + [_I] * 20 + [_P],
    "stnls_agg_gather_bwd": [_P] * 8 + [_I] * 15 + [_P],
    "stnls_nls_vol_fwd": [_P] * 5 + [_I] * 19 + [_F, _F] + [_I] * 6 + [_P],
    "stnls_nls_vol_bwd": [_P] * 10 + [_I] * 18 + [_F, _F] + [_I] * 7 + [_P],
    "stnls_agg_scatter_add_fwd": [_P] * 4 + [_I] * 22 + [_P],
    "stnls_agg_scatter_add_bwd": [_P] * 6 + [_I] * 23 + [_P],
    "stnls_agg_pool_fwd": [_P] * 4 + [_I] * 16 + [_P],
    "stnls_agg_pool_bwd": [_P] * 6 + [_I] * 20 + [_P],
    "stnls_nls_geometry_fwd": [_P] * 7 + [_I] * 16 + [_F, _F] + [_I] * 3
    + [_P],
    "stnls_nls_geometry_bwd": [_P] * 6 + [_I] * 15 + [_P],
    "stnls_search_flow_fwd": [_P] * 3 + [_I] * 8 + [_P],
    "stnls_search_flow_bwd": [_P] * 5 + [_I] * 8 + [_P],
    "stnls_nls_topk_compiled": [_I, _I],
    "stnls_nls_topk_swept": [_I, _I],
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


def channel_layout(F):
    """The channels-last layout of F channels a head that B2, B5, B6, B7
    and B10 read or add into: (vw, ng, np, Fp), vw channels a vector (1,
    2 or 4), ng lanes a query (a power of two up to 32), np passes of each
    lane, Fp = vw * ng * np >= F padded channels."""
    vw = 1 if F == 1 else 2 if F == 2 else 4
    nvec = -(-F // vw)
    ng = min(1 << (nvec - 1).bit_length(), 32)
    npass = -(-nvec // ng)
    return vw, ng, npass, vw * ng * npass


def grouped_channels(F):
    """The channels of the channels-last copy that B3 and B8 read for F
    channels a head: F up to 2, 4 up to 4, else a multiple of 8 (B3's
    threads take min(Fp, 8) channels, B8's 4 a load)."""
    return F if F <= 2 else 4 if F <= 4 else -(-F // 8) * 8


def channels_last(x, Fp):
    """[..., F, H, W] -> a new contiguous [..., H, W, Fp] tensor, the
    channels Fp - F >= 0 beyond F zero: the layout in which a pixel's
    channels are one vector load for B2, B3, B5, B6, B8 and B10."""
    F = x.shape[-3]
    moved = x.movedim(-3, -1)
    if Fp == F:
        return moved.contiguous()
    out = x.new_zeros(moved.shape[:-1] + (Fp,))
    out[..., :F] = moved
    return out


def channels_last_pair(vid0, vid1, Fp):
    """The channels-last copies of two videos that B2, B5 and B6 read: one
    copy, returned twice, where vid1 is vid0 (as a self-search passes)."""
    v0c = channels_last(vid0, Fp)
    same = vid1.data_ptr() == vid0.data_ptr() and \
        vid1.stride() == vid0.stride()
    return v0c, v0c if same else channels_last(vid1, Fp)


def channels_first(x, F):
    """The inverse of `channels_last`: [..., H, W, Fp] -> [..., F, H, W]."""
    return (x if x.shape[-1] == F else x[..., :F]).movedim(-1, -3).contiguous()


def stats_ptr(stats, device, name):
    """The pointer a kernel adds its 4 counts to: None, or the data of
    `stats`, a contiguous int64 tensor of 4 elements on `device`."""
    if stats is None:
        return None
    if stats.device != device or stats.dtype != torch.int64 or \
            stats.numel() != 4 or not stats.is_contiguous():
        raise ValueError(f"{name}: stats must be a contiguous int64 tensor "
                         "of 4 elements on the inputs' device")
    return stats.data_ptr()


def check_launch(err, name):
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
