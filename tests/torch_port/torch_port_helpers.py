"""Helpers of the port's parity tests: numpy -> torch, and the stated
tolerances."""

import numpy as np
import torch

TOL = 1e-4   # atol = rtol for forward outputs (BASELINE correctness target)


def to_torch(x, grad=False):
    return torch.from_numpy(np.array(x, dtype=np.float32)).requires_grad_(grad)


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_close(port, ref, what="", atol=TOL, rtol=TOL):
    np.testing.assert_allclose(to_np(port), to_np(ref), atol=atol, rtol=rtol,
                               err_msg=what)


def assert_grad_close(port, ref, what="", tol=TOL):
    """Gradients: atol = tol * max|g| (sums run in another order)."""
    ref = to_np(ref)
    scale = max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(to_np(port), ref, atol=tol * scale, rtol=0,
                               err_msg=what)


def assert_cells_match(cells, ref_cells, ref_dists):
    """Cells equal except at near-ties of the reference's ranked dists."""
    cells, ref_cells, d = to_np(cells), to_np(ref_cells), to_np(ref_dists)
    gap = np.abs(np.diff(d, axis=-1)) <= TOL * (1 + np.abs(d[..., 1:]))
    tie = np.zeros(d.shape, bool)
    tie[..., 1:] |= gap
    tie[..., :-1] |= gap
    tie[..., -1] = True
    assert ((cells == ref_cells) | tie).all()
    assert (cells == ref_cells).mean() > 0.99
