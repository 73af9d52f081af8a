"""Optical-flow computation wrapper (PyTorch port of
stnls_tpu/flow/__init__.py; the reference's flow/__init__.py).

Wraps OpenCV optical flow (TV-L1 when the contrib module is present,
Farneback otherwise, reference :121-150) with a zero-flow fallback when
cv2 is missing (reference :26-57), plus flow -> HSV visualisation. Flow
estimation is host-side preprocessing on numpy copies of the frames; the
flows come back as tensors on the video's device (numpy input stays on
the host), ready for the search. cv2 is optional: without it `run`
raises and the get_/orun helpers return zero flows.
"""

import numpy as np
import torch

from stnls_tpu_torch.utils.config import ConfigDict
from stnls_tpu_torch.utils.misc import host_array as _np

with_cv = False
try:
    import cv2
    with_cv = True
except ImportError:
    cv2 = None


def _device(x):
    return x.device if isinstance(x, torch.Tensor) else "cpu"


def init_flows(vshape, dtype=torch.float32, device="cuda"):
    t, c, h, w = vshape[-4:]
    flows = ConfigDict()
    flows.fflow = torch.zeros((t, 2, h, w), dtype=dtype, device=device)
    flows.bflow = torch.zeros((t, 2, h, w), dtype=dtype, device=device)
    return flows


def init_flows_batch(vshape, dtype=torch.float32, device="cuda"):
    b, t, c, h, w = vshape
    flows = ConfigDict()
    flows.fflow = torch.zeros((b, t, 2, h, w), dtype=dtype, device=device)
    flows.bflow = torch.zeros((b, t, 2, h, w), dtype=dtype, device=device)
    return flows


def get_flow_batch(run_flow, use_clean, noisy, clean, sigma):
    """Batched flow estimation with zero-flow fallback (reference :26-57).
    As in the JAX package, use_clean picks the *noisy* video here and the
    clean one in get_flow: the two are swapped against each other."""
    if run_flow and with_cv:
        vid = noisy if use_clean else clean
        ff, bf = [], []
        for b in range(vid.shape[0]):
            flows_b = run(vid[b], 0.)
            ff.append(flows_b.fflow)
            bf.append(flows_b.bflow)
        flows = ConfigDict()
        flows.fflow = torch.stack(ff)
        flows.bflow = torch.stack(bf)
        return flows
    return init_flows_batch(tuple(noisy.shape), device=_device(noisy))


def get_flow(run_flow, use_clean, noisy, clean, sigma):
    if run_flow and with_cv:
        return run(clean if use_clean else noisy, 0. if use_clean else sigma)
    return init_flows(tuple(noisy.shape), device=_device(noisy))


def _flow_pair(prev_gray, next_gray):
    """One flow field prev -> next; TV-L1 if available, else Farneback."""
    if hasattr(cv2, "optflow") and hasattr(cv2.optflow,
                                           "DualTVL1OpticalFlow_create"):
        tvl1 = cv2.optflow.DualTVL1OpticalFlow_create()
        return tvl1.calc(prev_gray, next_gray, None)
    if hasattr(cv2, "DualTVL1OpticalFlow_create"):
        tvl1 = cv2.DualTVL1OpticalFlow_create()
        return tvl1.calc(prev_gray, next_gray, None)
    return cv2.calcOpticalFlowFarneback(prev_gray, next_gray, None,
                                        0.5, 3, 15, 3, 5, 1.2, 0)


def run(vid, sigma=0.):
    """vid [T,C,H,W] (tensor or numpy, [0,255] or [0,1]) -> flows with
    .fflow/.bflow [T,2,H,W]; fflow[t] maps frame t -> t+1, bflow[t] maps
    frame t -> t-1 (endpoints zero)."""
    if not with_cv:
        raise RuntimeError("OpenCV not available; use "
                           "stnls_tpu_torch.flow.init_flows")
    device = _device(vid)
    vid = _np(vid).astype(np.float32)
    if vid.max() <= 1.5:
        vid = vid * 255.
    T, C, H, W = vid.shape
    grays = []
    for t in range(T):
        frame = np.transpose(vid[t], (1, 2, 0))
        if C == 3:
            g = cv2.cvtColor(frame.astype(np.uint8), cv2.COLOR_RGB2GRAY)
        else:
            g = frame[..., 0].astype(np.uint8)
        grays.append(g)
    fflow = np.zeros((T, 2, H, W), np.float32)
    bflow = np.zeros((T, 2, H, W), np.float32)
    for t in range(T - 1):
        f = _flow_pair(grays[t], grays[t + 1])  # [H,W,2] (dx,dy)
        fflow[t, 0] = f[..., 0]
        fflow[t, 1] = f[..., 1]
    for t in range(1, T):
        b = _flow_pair(grays[t], grays[t - 1])
        bflow[t, 0] = b[..., 0]
        bflow[t, 1] = b[..., 1]
    flows = ConfigDict()
    flows.fflow = torch.from_numpy(fflow).to(device)
    flows.bflow = torch.from_numpy(bflow).to(device)
    return flows


def run_batch(vid, sigma=0.):
    ff, bf = [], []
    for b in range(vid.shape[0]):
        flows_b = run(vid[b], sigma)
        ff.append(flows_b.fflow)
        bf.append(flows_b.bflow)
    flows = ConfigDict()
    flows.fflow = torch.stack(ff)
    flows.bflow = torch.stack(bf)
    return flows


def flow2img(flow):
    """Flow field [2,H,W] -> HSV-encoded RGB image [3,H,W] in [0,1]
    (reference's visualisation helper), on the flow's device."""
    device = _device(flow)
    flow = _np(flow)
    mag = np.sqrt(flow[0] ** 2 + flow[1] ** 2)
    ang = np.arctan2(flow[1], flow[0])
    hue = (ang + np.pi) / (2 * np.pi)
    sat = np.ones_like(hue)
    val = np.clip(mag / (mag.max() + 1e-8), 0, 1)
    h6 = hue * 6.
    i = np.floor(h6).astype(int) % 6
    f = h6 - np.floor(h6)
    p = val * (1 - sat)
    q = val * (1 - f * sat)
    t = val * (1 - (1 - f) * sat)
    rgb = np.choose(i[None], [
        np.stack([val, t, p]), np.stack([q, val, p]),
        np.stack([p, val, t]), np.stack([p, q, val]),
        np.stack([t, p, val]), np.stack([val, p, q])])
    return torch.from_numpy(np.ascontiguousarray(rgb)).to(device)


def pth2jax(flows):
    """The reference's torch-to-JAX flow conversion (reference :191-198),
    kept under its name for callers: the flows are tensors already, so it
    returns them as they are in a new dict."""
    out = ConfigDict()
    out.fflow = flows.fflow
    out.bflow = flows.bflow
    return out


def orun(vid, flow=True, ftype="cv2", sigma=0.):
    """Optional run (reference's `orun`): zero flows unless flow=True."""
    if flow and with_cv:
        return run_batch(vid, sigma) if vid.ndim == 5 else run(vid, sigma)
    if vid.ndim == 5:
        return init_flows_batch(tuple(vid.shape), device=_device(vid))
    return init_flows(tuple(vid.shape), device=_device(vid))
