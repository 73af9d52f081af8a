"""Port parity of the misc modules: utils/color (RGB <-> YUV),
misc/flow_patches and misc/vnlb (video non-local Bayes), against the JAX
package's functions on the DAVIS fixture (data/davis_baseball_64x64/,
read with PIL as stnls_tpu/testing/data.py reads it), and a grep of the
port for imports it must not make.

Tolerances: color at atol = rtol = 1e-4 (float32 sums of three terms);
flow_patches' patches equal and the scores at 1e-4. vnlb is held apart in
stages, since JAX's run_vnlb builds its search without `impl` and off the
TPU `auto` may take an engine that is not the truth:
  (a) the port's int search at vnlb's config against JAX's lattice engine:
      offsets equal;
  (b) on those offsets, the patch groups equal; the Bayes filter (on 64
      of the groups) in float64 in both packages within 1e-9 (it is a
      matrix function of the group covariance, V diag(c(e)) V^T with c
      Lipschitz, so it does not depend on how eigh splits a
      near-degenerate eigenspace: the float64 results differ by LAPACK
      rounding only), and in float32 within 1e-4; the fold within 1e-4
      (float sums in another order);
  (c) run_vnlb end to end (on a 32x32 crop) within atol = rtol = 1e-4:
      its two steps feed one search the other's float32 output, and (a)
      and (b) bound each stage's error far below that.
The port gains more than 4 dB of PSNR on the whole clip, as the JAX
package's tests/nn/test_misc.py requires of JAX's.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from stnls_tpu.misc import vnlb as jvnlb, flow_patches as jflow_patches
from stnls_tpu.search.non_local_search import NonLocalSearch as JSearch
from stnls_tpu.testing import data as tdata
from stnls_tpu.utils import color as jcolor
from stnls_tpu.utils.config import ConfigDict as JConfigDict
from stnls_tpu_torch.misc import vnlb, flow_patches
from stnls_tpu_torch.search.non_local_search import NonLocalSearch
from stnls_tpu_torch.utils import color
from stnls_tpu_torch.utils.config import ConfigDict

from torch_port_helpers import to_torch, assert_close

SIGMA = 30.
VNLB = {"sigma": SIGMA, "ws": 7, "wt": 1, "ps": 5, "k": 24, "stride0": 2,
        "nsteps": 2}
PORT = Path(__file__).resolve().parents[2] / "stnls_tpu_torch"


@pytest.fixture(scope="module")
def davis():
    """The fixture clip [1,3,3,64,64] in [0, 1] and its noisy copy (sigma
    30 / 255, numpy seed 0), as tests/nn/test_misc.py makes them."""
    clean = np.array(tdata.davis_baseball(3), dtype=np.float32)
    rng = np.random.default_rng(0)
    noisy = (clean + rng.standard_normal(clean.shape) * SIGMA / 255.) \
        .astype(np.float32)
    return clean, noisy


def psnr(a, b):
    return 10 * np.log10(1.0 / max(float(np.mean((a - b) ** 2)), 1e-12))


def test_color_matches_jax_and_round_trips(rng):
    rgb = rng.random((2, 3, 3, 8, 10)).astype(np.float32)
    t = to_torch(rgb)
    for name in ("rgb2yuv", "yuv2rgb", "rgb2gray", "yuv2rgb_patches"):
        got = getattr(color, name)(t)
        assert_close(got, getattr(jcolor, name)(jnp.asarray(rgb)), name)
    assert color.rgb2gray(t).shape == (2, 3, 1, 8, 10)
    assert_close(color.yuv2rgb(color.rgb2yuv(t)), rgb, "round trip")
    before = t.clone()
    color.rgb2yuv(t)
    assert torch.equal(t, before)           # functional: no write in place


def test_flow_patches_match_jax(davis):
    clean = davis[0]
    B, T, C, H, W = clean.shape
    rng = np.random.default_rng(0)
    zero = np.zeros((B, T, 2, H, W), np.float32)
    garbage = [(10 * rng.standard_normal((B, T, 2, H, W))).astype(np.float32)
               for _ in range(2)]
    smooth = [np.round(f, 1) + 0.5 for f in (
        np.broadcast_to(rng.uniform(-3, 3, (B, T, 2, 1, 1)),
                        (B, T, 2, H, W)).astype(np.float32) for _ in range(2))]
    scores = {}
    for label, (ff, bf) in (("zero", (zero, zero)), ("garbage", garbage),
                            ("half-integer", smooth)):
        jflows = JConfigDict(fflow=jnp.asarray(ff), bflow=jnp.asarray(bf))
        tflows = ConfigDict(fflow=to_torch(ff), bflow=to_torch(bf))
        jp = jflow_patches.get_patches(jnp.asarray(clean), jflows, 3)
        tp = flow_patches.get_patches(to_torch(clean), tflows, 3)
        for key in ("fflow", "bflow"):
            for got, ref in zip(tp[key], jp[key]):
                assert got.shape == (B, T, 9, C, H, W)
                np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        jm = jflow_patches.get_mse(jnp.asarray(clean), jflows, 3)
        tm = flow_patches.get_mse(to_torch(clean), tflows, 3)
        for key in ("fflow", "bflow"):
            assert isinstance(tm[key], float)
            assert_close(tm[key], jm[key], f"{label} {key} mse")
        scores[label] = tm
    for key in ("fflow", "bflow"):
        assert scores["zero"][key] < scores["garbage"][key]


def _vnlb_search(yuv):
    """(a): the offsets of vnlb's search on the video, in both packages
    (JAX on its lattice engine)."""
    kw = dict(stride0=VNLB["stride0"], dist_type="l2", self_action="anchor",
              itype="int")
    args = (VNLB["ws"], VNLB["wt"], VNLB["ps"], VNLB["k"])
    jd, ji = JSearch(*args, impl="lattice", **kw)(jnp.asarray(yuv),
                                                  jnp.asarray(yuv))
    td, ti = NonLocalSearch(*args, **kw)(to_torch(yuv), to_torch(yuv))
    return (td, ti), (np.array(jd), np.array(ji))


def test_vnlb_search_matches_lattice(davis):
    yuv = np.asarray(jcolor.rgb2yuv(jnp.asarray(davis[1])))
    (td, ti), (jd, ji) = _vnlb_search(yuv)
    assert ti.dtype == torch.int32 and ti.shape == (1, 1, 3, 32, 32, 24, 3)
    np.testing.assert_array_equal(ti.numpy(), ji)
    assert_close(td, jd, "dists")


def test_vnlb_stages_match_jax(davis):
    """(b): groups, Bayes filter and fold of both packages on the same
    offsets (JAX's lattice search)."""
    yuv = np.asarray(jcolor.rgb2yuv(jnp.asarray(davis[1])))
    _, (_, ji) = _vnlb_search(yuv)
    ps, s0 = VNLB["ps"], VNLB["stride0"]
    jg = np.array(jvnlb._gather_groups(jnp.asarray(yuv), jnp.asarray(ji),
                                         ps, s0))
    tg = vnlb._gather_groups(to_torch(yuv), torch.from_numpy(ji), ps, s0)
    assert tg.shape == (1, 3, 32, 32, 24, ps * ps * 3)
    np.testing.assert_array_equal(tg.numpy(), jg)

    # the filter on every 4th query of the first frame (64 groups): its
    # eigh is the slow part, and many test workers share the cores
    sub = np.ascontiguousarray(jg[:, :1, ::4, ::4])
    with jax.enable_x64(True):
        jf64 = np.asarray(jvnlb._bayes_filter(jnp.asarray(sub, jnp.float64),
                                              SIGMA))
    tf64 = vnlb._bayes_filter(torch.from_numpy(sub.astype(np.float64)),
                              SIGMA)
    assert tf64.dtype == torch.float64
    np.testing.assert_allclose(tf64.numpy(), jf64, atol=1e-9, rtol=0)
    jf = np.array(jvnlb._bayes_filter(jnp.asarray(sub), SIGMA))
    tf = vnlb._bayes_filter(torch.from_numpy(sub), SIGMA)
    assert_close(tf, jf, "filtered groups, float32")
    assert float(np.abs(jf - sub).max()) > 1e-2     # the filter did work

    # the fold is linear in the patches: fold the groups themselves
    jo = jvnlb._fold_groups(jnp.asarray(jg), jnp.asarray(ji), yuv.shape, ps,
                            s0)
    to = vnlb._fold_groups(torch.from_numpy(jg), torch.from_numpy(ji),
                           yuv.shape, ps, s0)
    assert to.shape == yuv.shape
    assert_close(to, jo, "fold")


def test_vnlb_denoises(davis):
    """The PSNR gain of tests/nn/test_misc.py (> 4 dB, the JAX package's
    own test) in the port, on the same clip."""
    clean, noisy = davis
    out = vnlb.run_vnlb(VNLB, to_torch(noisy)).numpy()
    assert np.isfinite(out).all()
    p_in, p_out = psnr(noisy, clean), psnr(out, clean)
    assert p_out > p_in + 4.0, f"vnlb must denoise: {p_in:.2f} -> {p_out:.2f}"


def test_vnlb_matches_jax_end_to_end(davis):
    """(c): run_vnlb of both packages on the clip's top-left 32x32 (a
    quarter of the batched eigh work: the suite's workers share the
    cores)."""
    noisy = np.ascontiguousarray(davis[1][..., :32, :32])
    out = vnlb.run_vnlb(VNLB, to_torch(noisy))
    ref = jvnlb.run_vnlb(VNLB, jnp.asarray(noisy))
    assert out.shape == noisy.shape
    assert_close(out, ref, "run_vnlb")


def test_port_source_imports_no_jax_pil_or_cv2():
    """No module of stnls_tpu_torch imports jax, flax or the JAX package,
    and none imports PIL or cv2 when it is imported (the card's machine
    has none of them): those two only inside a function or a guarded try
    (flow, testing.data, utils.vid_io), as in the JAX package."""
    banned = re.compile(r"^\s*(import|from)\s+(jax|flax|stnls_tpu)"
                        r"(\.|\s|$)", re.M)
    top_level = re.compile(r"^(import|from)\s+(PIL|cv2)(\.|\s|$)", re.M)
    files = sorted(PORT.rglob("*.py"))
    assert len(files) > 40
    bad = [str(f) for f in files if banned.search(f.read_text())
           or top_level.search(f.read_text())]
    assert not bad, bad
