"""Video IO (PyTorch port of stnls_tpu/utils/vid_io.py, the reference's
utils/vid_io.py): save/load frame bursts as npy stacks or, with PIL
(imported only then), image files."""

from pathlib import Path

import numpy as np
import torch

from stnls_tpu_torch.utils.misc import host_array


def save_video(vid, root, name, itype="npy"):
    """Save [*, C, H, W]-style video tensors. itype: npy (always) or png
    (requires PIL)."""
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    vid = host_array(vid)
    if itype == "npy":
        np.save(root / f"{name}.npy", vid)
        return [str(root / f"{name}.npy")]
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("png output needs PIL; use itype='npy'") from e
    vid = vid.reshape((-1,) + vid.shape[-3:])
    paths = []
    for ti, frame in enumerate(vid):
        arr = np.clip(frame * 255., 0, 255).astype(np.uint8)
        arr = np.transpose(arr, (1, 2, 0))
        if arr.shape[-1] == 1:
            arr = arr[..., 0]
        p = root / f"{name}_{ti:05d}.png"
        Image.fromarray(arr).save(p)
        paths.append(str(p))
    return paths


def read_video(root, name=None, itype="npy", device="cuda"):
    """The saved video as a tensor on `device`."""
    root = Path(root)
    if itype == "npy":
        path = root / f"{name}.npy" if name else root
        return torch.from_numpy(np.load(path)).to(device)
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("png input needs PIL; use itype='npy'") from e
    frames = []
    for p in sorted(root.glob(f"{name}_*.png" if name else "*.png")):
        arr = np.asarray(Image.open(p)).astype(np.float32) / 255.
        if arr.ndim == 2:
            arr = arr[..., None]
        frames.append(np.transpose(arr, (2, 0, 1)))
    return torch.from_numpy(np.stack(frames)).to(device)
