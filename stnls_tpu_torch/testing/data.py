"""Test fixture loading (PyTorch port of stnls_tpu/testing/data.py; the
reference's testing/data.py:14-40): the 5-frame DAVIS baseball 64x64
clip at data/davis_baseball_64x64/. PIL is imported only to read it."""

from pathlib import Path

import numpy as np
import torch

MAX_FRAMES = 85
_REPO_ROOT = Path(__file__).resolve().parents[2]


def _load_frames(root, name, nframes, ext):
    """[T,3,H,W] float32 numpy frames in [0, 255]."""
    from PIL import Image
    path = Path(root) / name
    if not path.exists():
        raise FileNotFoundError(f"missing burst dir {path}")
    burst = []
    nframes = nframes if nframes > 0 else MAX_FRAMES
    for t in range(nframes):
        fn = None
        for e in (ext, "png", "jpg"):
            cand = path / f"{t:05d}.{e}"
            if cand.exists():
                fn = cand
                break
        if fn is None:
            break
        img = Image.open(str(fn)).convert("RGB")
        burst.append(np.array(img).transpose(2, 0, 1))
    return np.ascontiguousarray(np.stack(burst).astype(np.float32))


def load_burst(root, name, nframes=-1, ext="jpg", device="cuda"):
    """The frames root/name/00000.ext, ... as [T,3,H,W] float32 in
    [0, 255] on `device`."""
    return torch.from_numpy(_load_frames(root, name, nframes, ext)) \
        .to(device)


def load_burst_batch(root, names, nframes=-1, ext="jpg", device="cuda"):
    return torch.stack([load_burst(root, n, nframes, ext, device)
                        for n in names])


def davis_baseball(nframes=-1, device="cuda"):
    """The repo's bundled fixture clip, scaled to [0,1]: [1,T,3,64,64]."""
    vid = load_burst_batch(_REPO_ROOT / "data", ["davis_baseball_64x64"],
                           nframes, device=device)
    return vid / 255.0
