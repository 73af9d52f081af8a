"""Visualize non-local search indices on a video (PyTorch port of
stnls_tpu/utils/viz_inds.py: the reference's utils/viz_inds.py ships
broken; this draws one annotated RGB frame per time step with the
selected non-local locations on top).

Host-side numpy: tensors are copied to the host first. matplotlib is
optional and imported only by `save_grid`, which falls back to a raw
.npy of the frames without it.
"""

import numpy as np

from stnls_tpu_torch.utils.misc import host_array as _np


def _abs_coords(inds, t, stride0=1):
    """Collect absolute (t,h,w) targets of all edges landing in frame t.

    inds: [T, nH, nW, K, 3] relative offsets (reference get_inds_t
    gathers per-frame indices; we convert relative->absolute first)."""
    inds = np.round(_np(inds)).astype(np.int64)
    T, nH, nW, K, _ = inds.shape
    tt = np.arange(T)[:, None, None, None]
    hh = (np.arange(nH) * stride0)[None, :, None, None]
    ww = (np.arange(nW) * stride0)[None, None, :, None]
    at = tt + inds[..., 0]
    ah = hh + inds[..., 1]
    aw = ww + inds[..., 2]
    sel = at == t
    return np.stack([ah[sel], aw[sel]], -1)


def _to_hwc(img):
    img = _np(img).astype(np.float32)
    if img.ndim == 3 and img.shape[0] in (1, 3):   # c h w -> h w c
        img = np.transpose(img, (1, 2, 0))
    if img.shape[-1] == 1:
        img = np.repeat(img, 3, -1)
    lo, hi = img.min(), img.max()
    if hi > lo:
        img = (img - lo) / (hi - lo)
    return img


def run(vid, inds, stride0=1, dpi=200, colors=None, s=2):
    """Annotate each frame with its incoming non-local locations.

    vid: [T, C, H, W] (array-like); inds: [T, nH, nW, K, 3] relative
    offsets. Returns a list of [H, W, 3] float RGB frames in [0, 1].
    """
    vid = _np(vid)
    T = vid.shape[0]
    H, W = vid.shape[-2:]
    if colors is None:
        colors = [(1.0, max(0.0, 1.0 - 2.0 * t / max(1, T - 1)),
                   t / max(1, T - 1)) for t in range(T)]
    annos = []
    for t in range(T):
        img = _to_hwc(vid[t]).copy()
        coords = _abs_coords(inds, t, stride0)
        color = np.asarray(colors[t % len(colors)], np.float32)
        for (h, w) in coords:
            h0, h1 = max(0, h - s // 2), min(H, h + s // 2 + 1)
            w0, w1 = max(0, w - s // 2), min(W, w + s // 2 + 1)
            if h1 > h0 and w1 > w0:
                img[h0:h1, w0:w1] = color
        annos.append(img)
    return annos


def save_grid(annos, path, dpi=200):
    """Save annotated frames as one row image (matplotlib optional)."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:   # headless fallback: hstack + raw .npy
        np.save(path if path.endswith(".npy") else path + ".npy",
                np.concatenate(annos, axis=1))
        return
    fig, axes = plt.subplots(1, len(annos), figsize=(3 * len(annos), 3),
                             dpi=dpi, tight_layout=True)
    if len(annos) == 1:
        axes = [axes]
    for ax, img in zip(axes, annos):
        ax.imshow(img, origin="upper", interpolation="nearest")
        ax.axis("off")
    fig.savefig(path, bbox_inches="tight", pad_inches=0)
    plt.close(fig)
