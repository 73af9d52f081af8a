"""Flag-gated runtime checks (PyTorch port of stnls_tpu/utils/debug.py:
the reference's defensive asserts, NaN checks at agg/gather.py:124,149,
counts > 0 at gather.py:141).

Off by default. While on, each check reads its tensor (a device-to-host
copy, which waits for the card) and raises a Python RuntimeWarning on a
hit; while off it reads nothing:

    stnls_tpu_torch.utils.debug.set_debug_checks(True)
"""

import warnings

import torch

_DEBUG_CHECKS = False


def set_debug_checks(enabled):
    """Globally enable/disable the runtime debug checks."""
    global _DEBUG_CHECKS
    _DEBUG_CHECKS = bool(enabled)


def debug_checks_enabled():
    return _DEBUG_CHECKS


def _warn(count, msg):
    count = int(count)
    if count > 0:
        warnings.warn(f"stnls_tpu_torch debug check: {msg} ({count} hits)",
                      RuntimeWarning, stacklevel=3)


def emit_count_warning(count, msg):
    """When debug checks are on, warn if `count` (an int or a one-element
    tensor) is nonzero."""
    if _DEBUG_CHECKS:
        _warn(count, msg)


def check_finite(x, msg):
    """Warn if `x` contains NaN/Inf (reference gather.py:124,149)."""
    if _DEBUG_CHECKS:
        _warn(x.numel() - torch.isfinite(x).sum(), msg)


def check_positive(x, msg):
    """Warn if any entry of `x` is <= 0 (reference gather.py:141)."""
    if _DEBUG_CHECKS:
        _warn((x <= 0).sum(), msg)
