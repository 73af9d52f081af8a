"""The channels-last layout B2, B5 and B6 share (ops/cuda_lib.
channel_layout, channels_last_pair), and the C entries of the kernel
library against the ctypes signatures cuda_lib.load() gives them, on the
CPU (the library itself is built and run only on the card).
"""

import ctypes
import re

import numpy as np
import pytest
import torch

from stnls_tpu_torch.ops import cuda_lib


@pytest.mark.parametrize("same", [True, False])
def test_channels_last_pair(same):
    rng = np.random.default_rng(3)
    v0 = torch.from_numpy(rng.standard_normal((1, 2, 3, 5, 4, 6))
                          .astype(np.float32))
    v1 = v0 if same else torch.from_numpy(
        rng.standard_normal(v0.shape).astype(np.float32))
    Fp = cuda_lib.channel_layout(5)[3]
    c0, c1 = cuda_lib.channels_last_pair(v0, v1, Fp)
    assert (c1 is c0) == same
    assert torch.equal(cuda_lib.channels_first(c0, 5), v0)
    assert torch.equal(cuda_lib.channels_first(c1, 5), v1)
    assert c0.shape == (1, 2, 3, 4, 6, Fp) and c0.is_contiguous()


@pytest.mark.parametrize("F", [1, 2, 3, 4, 5, 8, 16, 32, 33, 128, 200])
def test_channel_layout(F):
    vw, ng, npass, Fp = cuda_lib.channel_layout(F)
    assert vw == (1 if F == 1 else 2 if F == 2 else 4)
    assert Fp == vw * ng * npass and Fp >= F and Fp - F < vw * ng
    assert 1 <= ng <= 32 and ng & (ng - 1) == 0
    x = torch.arange(2 * F * 6, dtype=torch.float32).reshape(2, F, 2, 3)
    cl = cuda_lib.channels_last(x, Fp)
    assert cl.shape == (2, 2, 3, Fp) and not cl[..., F:].any()
    assert torch.equal(cuda_lib.channels_first(cl, F), x)


def _c_entries():
    """{name: [parameter declarations]} of every `extern "C" int` entry
    defined in csrc/*.cu, comments removed; a name defined twice is listed
    twice."""
    entries = {}
    for src in sorted(cuda_lib.CSRC.glob("*.cu")):
        text = re.sub(r"/\*.*?\*/", "", src.read_text(), flags=re.S)
        text = re.sub(r"//[^\n]*", "", text)
        for name, params in re.findall(
                r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)\s*\{', text):
            entries.setdefault(name, []).append(
                [p.strip() for p in params.split(",")])
    return entries


def _ctype(decl):
    """The ctypes type a C parameter declaration passes as: any pointer
    (the stream's void* included) c_void_p, int c_int, float c_float."""
    if "*" in decl:
        return ctypes.c_void_p
    kind = " ".join(decl.split()[:-1])
    return {"int": ctypes.c_int, "float": ctypes.c_float}[kind]


@pytest.mark.parametrize("name", sorted(cuda_lib.SIGNATURES))
def test_kernel_entry_matches_its_ctypes_signature(name):
    defined = _c_entries().get(name, [])
    assert len(defined) == 1, f"{name} defined {len(defined)} times"
    params = defined[0]
    argtypes = cuda_lib.SIGNATURES[name]
    assert len(params) == len(argtypes), (name, len(params), len(argtypes))
    for i, (decl, want) in enumerate(zip(params, argtypes)):
        assert _ctype(decl) is want, f"{name} parameter {i} ({decl})"
