"""Inputs made on the device from the run's seed: videos, noise, smooth
optical flows and the weights of a model, each in a few large calls of a
torch.Generator on the card.

`smooth_flows` is a torch rewrite of the bring-up's numpy generator
(stnls_tpu_torch/attn_step.py): per (batch, frame, component) a sum of
`modes` products cos(ky y + a) cos(kx x + b) with ky, kx in {0, 1, 2},
normal amplitudes, scaled so that its largest |value| is amp * u, u
uniform in [0.5, 1). The same seed gives the same inputs on the same
device; both the program and the reference get them.
"""

import math

import torch


def generator(seed, device):
    """A torch.Generator on `device` seeded from any whole number (the
    seed is folded into 63 bits)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    return gen


def smooth_flows(gen, shape, amp, modes, device):
    """Low-frequency flow fields [B,T,2,H,W], |flow| <= amp."""
    B, T, C, H, W = shape
    n = B * T * C
    k = torch.randint(0, 3, (n, modes, 2), generator=gen, device=device)
    ph = torch.rand((n, modes, 2), generator=gen, device=device) \
        * (2 * math.pi)
    a = torch.randn((n, modes), generator=gen, device=device)
    u = torch.rand((n,), generator=gen, device=device) * 0.5 + 0.5
    y = torch.arange(H, device=device, dtype=torch.float32) \
        * (2 * math.pi / H)
    x = torch.arange(W, device=device, dtype=torch.float32) \
        * (2 * math.pi / W)
    cy = torch.cos(k[..., 0, None] * y + ph[..., 0, None])   # [n,modes,H]
    cx = torch.cos(k[..., 1, None] * x + ph[..., 1, None])   # [n,modes,W]
    f = torch.einsum("nm,nmh,nmw->nhw", a, cy, cx)
    peak = f.abs().amax(dim=(1, 2)) + 1e-8
    f = f * (amp * u / peak)[:, None, None]
    return f.reshape(B, T, C, H, W).contiguous()


def normal(gen, shape, device):
    return torch.randn(shape, generator=gen, device=device)


def uniform_weights(gen, shapes, bounds, device):
    """One uniform draw on (-1, 1) for every tensor in `shapes`, each
    scaled by its bound: a list of tensors."""
    sizes = [math.prod(s) for s in shapes]
    flat = torch.rand((sum(sizes),), generator=gen, device=device) * 2 - 1
    return [chunk.reshape(s) * b for chunk, s, b in
            zip(flat.split(sizes), shapes, bounds)]
