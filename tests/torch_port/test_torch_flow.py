"""The port's flow module against the JAX package's: flow.run and
run_batch on the DAVIS clip (OpenCV on the same frames, so the flows are
equal), get_flow/get_flow_batch (each branch, and use_clean picking the
noisy video in get_flow_batch but the clean one in get_flow, as in the
JAX package), init_flows*, flow2img, orun and pth2jax."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import stnls_tpu
from stnls_tpu_torch import flow
from stnls_tpu_torch.testing import data

from torch_port_helpers import to_np

jflow = stnls_tpu.flow


@pytest.fixture(scope="module")
def clip():
    """The DAVIS clip [1,3,3,64,64] in [0,1] and a seeded noisy copy."""
    if not flow.with_cv:
        pytest.skip("needs cv2")
    vid = data.davis_baseball(3, device="cpu")
    rng = np.random.default_rng(0)
    noisy = vid + 0.1 * torch.from_numpy(
        rng.standard_normal(tuple(vid.shape)).astype(np.float32))
    return vid, noisy


def assert_flows_equal(port, ref):
    for key in ("fflow", "bflow"):
        got = getattr(port, key)
        assert isinstance(got, torch.Tensor)
        np.testing.assert_array_equal(to_np(got), np.asarray(getattr(ref,
                                                                     key)))


def test_run_and_run_batch_match_jax(clip):
    vid, _ = clip
    port = flow.run(vid[0])
    assert_flows_equal(port, jflow.run(jnp.asarray(vid[0].numpy())))
    assert port.fflow.shape == (3, 2, 64, 64) and port.fflow.any()
    assert not port.fflow[-1].any() and not port.bflow[0].any()
    batch = flow.run_batch(vid)
    assert batch.fflow.shape == (1, 3, 2, 64, 64)
    assert torch.equal(batch.fflow[0], port.fflow)
    assert_flows_equal(flow.orun(vid), jflow.orun(jnp.asarray(vid.numpy())))


def test_get_flow_keeps_the_swapped_use_clean(clip):
    """get_flow_batch(use_clean=True) runs on the noisy video and
    get_flow(use_clean=True) on the clean one, in both packages."""
    vid, noisy = clip
    j_vid, j_noisy = jnp.asarray(vid.numpy()), jnp.asarray(noisy.numpy())
    for use_clean in (True, False):
        got = flow.get_flow_batch(True, use_clean, noisy, vid, 0.1)
        assert_flows_equal(got, jflow.get_flow_batch(True, use_clean,
                                                     j_noisy, j_vid, 0.1))
        picked = noisy if use_clean else vid
        assert torch.equal(got.fflow, flow.run_batch(picked).fflow)
        one = flow.get_flow(True, use_clean, noisy[0], vid[0], 0.1)
        assert_flows_equal(one, jflow.get_flow(True, use_clean, j_noisy[0],
                                               j_vid[0], 0.1))
        assert torch.equal(one.fflow,
                           flow.run(vid[0] if use_clean else noisy[0]).fflow)
    zero = flow.get_flow_batch(False, True, noisy, vid, 0.1)
    assert zero.fflow.shape == (1, 3, 2, 64, 64) and not zero.fflow.any()
    assert zero.fflow.device == noisy.device
    assert not flow.get_flow(False, True, noisy[0], vid[0], 0.1).bflow.any()


def test_init_flows_flow2img_orun_pth2jax(rng):
    f = flow.init_flows((2, 3, 4, 5), dtype=torch.float64, device="cpu")
    assert f.fflow.shape == (2, 2, 4, 5) and f.fflow.dtype == torch.float64
    fb = flow.init_flows_batch((1, 2, 3, 4, 5), device="cpu")
    assert fb.bflow.shape == (1, 2, 2, 4, 5) and not fb.bflow.any()
    field = rng.standard_normal((2, 6, 7)).astype(np.float32)
    img = flow.flow2img(torch.from_numpy(field))
    assert img.shape == (3, 6, 7)
    np.testing.assert_array_equal(img.numpy(),
                                  np.asarray(jflow.flow2img(field)))
    zeros = flow.orun(torch.zeros(1, 2, 3, 4, 5), flow=False)
    assert zeros.fflow.shape == (1, 2, 2, 4, 5)
    assert flow.orun(torch.zeros(2, 3, 4, 5), flow=False).fflow.shape == \
        (2, 2, 4, 5)
    same = flow.pth2jax(fb)
    assert same.fflow is fb.fflow and same.bflow is fb.bflow
