"""Index/gradient checking helpers (PyTorch port of
stnls_tpu/testing/checks.py; the reference's testing/__init__.py
find_duplicate_inds, check_shuffled_inds:20-35, gradcheck.py)."""

import numpy as np
import torch

from stnls_tpu_torch.utils.misc import host_array as _np


def find_duplicate_inds(inds):
    """inds [..., K, D]: per-entry bool mask of duplicated rows plus a
    global any-flag."""
    arr = _np(inds)
    flat = arr.reshape(-1, arr.shape[-2], arr.shape[-1])
    dups = np.zeros(flat.shape[:2], bool)
    for i in range(flat.shape[0]):
        seen = {}
        for k in range(flat.shape[1]):
            key = tuple(np.round(flat[i, k], 5))
            if key in seen:
                dups[i, k] = True
            else:
                seen[key] = k
    dups = dups.reshape(arr.shape[:-1])
    return dups, bool(dups.any())


def check_shuffled_inds(inds0, inds1, atol=1e-4):
    """True if inds1 is a per-query permutation of inds0."""
    a = _np(inds0, np.float64)
    b = _np(inds1, np.float64)
    if a.shape != b.shape:
        return False
    a2 = a.reshape(-1, a.shape[-2], a.shape[-1])
    b2 = b.reshape(-1, b.shape[-2], b.shape[-1])
    for i in range(a2.shape[0]):
        sa = a2[i][np.lexsort(a2[i].T)]
        sb = b2[i][np.lexsort(b2[i].T)]
        if not np.allclose(sa, sb, atol=atol):
            return False
    return True


def gradcheck(fn, args, argnums=0, eps=1e-3, rtol=5e-2, atol=1e-2,
              n_checks=8, seed=0):
    """Numeric-Jacobian spot check of torch.autograd.grad of fn (role of
    the reference's torch.autograd.gradcheck wrappers): at n_checks
    elements of each argument in argnums, drawn by numpy's default_rng
    (seed) as in the JAX package, the gradient against the central
    difference of fn at +-eps. fn takes tensors and returns a scalar
    tensor. Returns True or raises."""
    if isinstance(argnums, int):
        argnums = (argnums,)
    args = list(args)
    wrt = [args[an].detach().requires_grad_() for an in argnums]
    call = list(args)
    for an, x in zip(argnums, wrt):
        call[an] = x
    grads = torch.autograd.grad(fn(*call), wrt)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for gi, an in enumerate(argnums):
            x = args[an].detach()
            g = grads[gi]
            for _ in range(n_checks):
                idx = tuple(int(rng.integers(0, s)) for s in x.shape)
                e = torch.zeros_like(x)
                e[idx] = eps
                args_p = list(args)
                args_m = list(args)
                args_p[an] = x + e
                args_m[an] = x - e
                fd = (fn(*args_p) - fn(*args_m)) / (2 * eps)
                np.testing.assert_allclose(_np(g[idx]), _np(fd),
                                           rtol=rtol, atol=atol)
    return True
