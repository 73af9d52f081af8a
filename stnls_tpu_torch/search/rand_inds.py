"""RandIndsSearch: search at randomized indices (PyTorch port of
stnls_tpu/search/rand_inds.py): an exact NonLocalSearch on noise videos
picks the offsets, then RefineSearch evaluates the real videos there.

The noise comes from a torch.Generator seeded from `seed` on the videos'
device (or one the caller passes), so its stream is not jax.random's;
`rands` takes the two noise videos directly.
"""

import torch

from stnls_tpu_torch.search.non_local_search import (
    init as init_nls, extract_config as extract_config_nls)
from stnls_tpu_torch.search.refinement import (
    init as init_refine, extract_config as extract_config_refine)


class RandIndsSearch(torch.nn.Module):
    """dists, inds = search(vid0, vid1[, generator][, rands=(r0, r1)])."""

    def __init__(self, nls, refine, seed=0):
        super().__init__()
        self.nls = nls
        self.refine = refine
        self.seed = seed

    def forward(self, vid0, vid1, generator=None, rands=None):
        if rands is None:
            if generator is None:
                generator = torch.Generator(device=vid0.device)
                generator.manual_seed(self.seed)
            rands = tuple(torch.randn(v.shape, generator=generator,
                                      dtype=v.dtype, device=v.device)
                          for v in (vid0, vid1))
        rand0, rand1 = rands
        B = vid0.shape[0]
        T = vid0.shape[1] if vid0.ndim == 5 else vid0.shape[2]
        H, W = vid0.shape[-2:]
        zflow = torch.zeros((B, T, 2, H, W), dtype=vid0.dtype,
                            device=vid0.device)
        with torch.no_grad():
            _, inds = self.nls(rand0, rand1, zflow, zflow)
        return self.refine(vid0, vid1, inds)


def extract_config(cfg, restrict=True):
    out = extract_config_nls(cfg, restrict=restrict)
    ref = extract_config_refine(cfg, restrict=restrict)
    for key, val in ref.items():
        if key not in out:
            out[key] = val
    return out


def init(cfg):
    cfg = extract_config(cfg, False)
    for key, val in {"wr": 1, "kr": -1}.items():
        if cfg[key] != val:
            cfg[key] = val
            print(f"WARNING: rand_inds requires ({key},{val}). "
                  "Changing config.")
    return RandIndsSearch(init_nls(cfg), init_refine(cfg))
