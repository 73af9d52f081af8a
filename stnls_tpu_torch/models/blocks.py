"""Misc model blocks (PyTorch port of stnls_tpu/models/blocks.py):
ResBlockList and squeeze-excite ChannelAttention on [N,C,H,W].

flax infers a layer's input width from its first call; torch takes it at
construction, so every block here is built from its `dim`.
`params_from_jax` (stnls_tpu_torch.convert) carries flax parameters over.
"""

import torch
import torch.nn.functional as F_


def _conv2d(in_dim, features, ksize):
    """A flax Conv with padding "SAME" and stride 1: zero padding that
    keeps [N,C,H,W] -> [N,features,H,W]."""
    return torch.nn.Conv2d(in_dim, features, ksize, padding="same")


class ResBlock(torch.nn.Module):
    def __init__(self, dim, ksize=3):
        super().__init__()
        self.conv0 = _conv2d(dim, dim, ksize)
        self.conv1 = _conv2d(dim, dim, ksize)

    def forward(self, x):
        return x + self.conv1(F_.relu(self.conv0(x)))


class ResBlockList(torch.nn.Module):
    """nblocks ResBlocks, named block0, block1, ... as in flax."""

    def __init__(self, nblocks, dim, ksize=3):
        super().__init__()
        self.nblocks = nblocks
        for i in range(nblocks):
            self.add_module(f"block{i}", ResBlock(dim, ksize))

    def forward(self, x):
        for i in range(self.nblocks):
            x = getattr(self, f"block{i}")(x)
        return x


class ChannelAttention(torch.nn.Module):
    """Squeeze-excite channel attention: the mean over (H, W), two linear
    layers (flax Dense_0, Dense_1) around a relu, and a sigmoid gate."""

    def __init__(self, dim, reduction=4):
        super().__init__()
        hidden = max(dim // reduction, 1)
        self.dense0 = torch.nn.Linear(dim, hidden)
        self.dense1 = torch.nn.Linear(hidden, dim)

    def forward(self, x):
        pooled = x.mean(dim=(-2, -1))                       # [N,C]
        gate = torch.sigmoid(self.dense1(F_.relu(self.dense0(pooled))))
        return x * gate[..., None, None]
