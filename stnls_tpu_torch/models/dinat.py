"""DiNAT, the Dilated Neighborhood Attention Transformer (Hassani and
Shi, "Dilated Neighborhood Attention Transformer", arXiv:2209.15001; on
NAT, Hassani et al., CVPR 2023, arXiv:2204.07143; the upstream
`classification/dinat.py`), with its attention on the port's search and
pooled sum.

    logits = DiNAT()(images)        # [B,3,224,224] -> [B,1000]

The defaults are `dinat_tiny`. All float32; tokens are channels-last,
[B,H,W,C]:
  * ConvTokenizer: two 3x3 stride-2 convs (3 -> C/2 -> C, no activation
    between them), then a LayerNorm: 224^2 becomes 56^2;
  * four levels of NATLayers, x + NA(LN(x)) then x + MLP(LN(x)) (an MLP of
    mlp_ratio, GELU), each level but the last followed by a ConvDownsampler
    (a 3x3 stride-2 conv to 2C without bias, then a LayerNorm);
  * the head: a LayerNorm, the mean over tokens, a linear layer.

Neighborhood attention is the library's search with the time axis
removed: each query attends to the k x k window around it, shifted at a
border to stay inside the map (`full_ws`); dilated NA (DiNA) takes every
d-th pixel, its window clamped inside the query's residue class mod d,
which is the same clamp on a search grid of spacing stride1 = d. All k^2
cells are kept (k = -1, topk_mode "none"), the logits are the "prod"
distances of the scaled queries, plus a relative-position bias
rpb[h, k - 1 + dy / d, k - 1 + dx / d]; the value sum over the softmax
is PooledPatchSum at ps 1 (on the card B5 and B9, backward B6 and B10,
one launch each a layer). The pool writes query q's sum at q + 1 (ps 1,
agg/pool), so it runs on a map, weights and offsets padded by one row
and column at the end: the padding's queries carry weight 0, and their
sums fall off the grid.

Spans: stnls.dinat.na around each attention core, from the split of the
qkv projection into heads to the merged heads (the search's
stnls.search.* and the pool's stnls.agg.pool inside it);
`NeighborhoodAttention.calls` counts the attention layers run.
"""

import torch
import torch.nn.functional as F_

from stnls_tpu_torch.agg.pool import PooledPatchSum
from stnls_tpu_torch.ops.geometry import search_offsets
from stnls_tpu_torch.search.non_local_search import NonLocalSearch
from stnls_tpu_torch.utils.spans import span

# dinat_tiny's dilations: d = map // k alternating with 1, level by level
DINAT_TINY_DILATIONS = ((1, 8, 1), (1, 4, 1, 4), (1, 2) * 9, (1,) * 5)

_BIAS_INDEX = {}


def bias_index(H, W, kernel, dilation, device):
    """[H*W*k*k] flat index into a [2k-1, 2k-1] bias table of each (query,
    window cell), cells row-major as the search orders them: per axis
    k - 1 + (neighbour - query) / d, from the search's own window offsets
    (ops/geometry.search_offsets on the integer grid)."""
    key = (H, W, kernel, dilation, str(device))
    if key not in _BIAS_INDEX:
        cells = torch.arange(kernel, device=device)

        def axis(L):
            x = torch.arange(L, device=device, dtype=torch.int32)
            off, _ = search_offsets(x, x, dilation, kernel, L, L, True, True)
            return kernel - 1 + cells[None, :] - off[:, None]   # [L, k]

        iy, ix = axis(H), axis(W)
        idx = iy[:, None, :, None] * (2 * kernel - 1) + ix[None, :, None, :]
        _BIAS_INDEX[key] = idx.reshape(-1)
    return _BIAS_INDEX[key]


class NeighborhoodAttention(torch.nn.Module):
    """Dilated neighborhood attention on [B,H,W,C] (see the module's
    docstring). `NeighborhoodAttention.calls` counts the calls."""

    calls = 0

    def __init__(self, dim, num_heads, kernel_size=7, dilation=1):
        super().__init__()
        self.heads, self.head_dim = num_heads, dim // num_heads
        self.kernel, self.dilation = kernel_size, dilation
        self.scale = self.head_dim ** -0.5
        self.qkv = torch.nn.Linear(dim, 3 * dim)
        self.rpb = torch.nn.Parameter(torch.zeros(
            num_heads, 2 * kernel_size - 1, 2 * kernel_size - 1))
        self.proj = torch.nn.Linear(dim, dim)
        self.search = NonLocalSearch(
            kernel_size, 0, ps=1, k=-1, nheads=num_heads, dist_type="prod",
            stride0=1, stride1=dilation, full_ws=True, self_action=None,
            topk_mode="none", itype="int")
        self.pool = PooledPatchSum(ps=1, stride0=1)

    def forward(self, x):
        NeighborhoodAttention.calls += 1
        B, H, W, C = x.shape
        k, d, HD, Fh = self.kernel, self.dilation, self.heads, self.head_dim
        if min(H, W) < k * d:
            raise ValueError(f"a {H}x{W} map is smaller than the dilated "
                             f"window, {k} x {d}")
        qkv = self.qkv(x)
        with span("stnls.dinat.na"):
            # [B,H,W,3,HD,Fh] -> q, k, v [B,HD,1,Fh,H,W] (views)
            q, key, v = qkv.reshape(B, H, W, 3, HD, Fh) \
                .permute(3, 0, 4, 5, 1, 2)[:, :, :, None].unbind(0)
            dists, inds = self.search(q * self.scale, key)
            bias = self.rpb.flatten(1)[:, bias_index(H, W, k, d, x.device)]
            wts = torch.softmax(dists + bias.reshape(HD, 1, H, W, k * k), -1)
            # one row and column of padding at the end (the module's
            # docstring)
            wts = F_.pad(wts, (0, 0, 0, 1, 0, 1))
            inds = F_.pad(inds, (0, 0, 0, 0, 0, 1, 0, 1)).float()
            out = self.pool(F_.pad(v, (0, 1, 0, 1)), wts, inds)
            out = out[:, :, 0, :, 1:, 1:]
            out = out.permute(0, 3, 4, 1, 2).reshape(B, H, W, C)
        return self.proj(out)


class NATLayer(torch.nn.Module):
    def __init__(self, dim, num_heads, kernel_size, dilation, mlp_ratio):
        super().__init__()
        self.norm1 = torch.nn.LayerNorm(dim)
        self.attn = NeighborhoodAttention(dim, num_heads, kernel_size,
                                          dilation)
        self.norm2 = torch.nn.LayerNorm(dim)
        self.mlp = torch.nn.Module()
        self.mlp.fc1 = torch.nn.Linear(dim, int(dim * mlp_ratio))
        self.mlp.fc2 = torch.nn.Linear(int(dim * mlp_ratio), dim)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp.fc2(F_.gelu(self.mlp.fc1(self.norm2(x))))


class ConvDownsampler(torch.nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.reduction = torch.nn.Conv2d(dim, 2 * dim, 3, 2, 1, bias=False)
        self.norm = torch.nn.LayerNorm(2 * dim)

    def forward(self, x):
        return self.norm(self.reduction(x.permute(0, 3, 1, 2))
                         .permute(0, 2, 3, 1))


class DiNAT(torch.nn.Module):
    """DiNAT for ImageNet classification (see the module's docstring);
    parameters named as the upstream model's, so that its checkpoints
    load."""

    def __init__(self, embed_dim=64, depths=(3, 4, 18, 5),
                 num_heads=(2, 4, 8, 16), kernel_size=7,
                 dilations=DINAT_TINY_DILATIONS, mlp_ratio=3.,
                 num_classes=1000, in_chans=3):
        super().__init__()
        C = embed_dim
        self.patch_embed = torch.nn.Module()
        self.patch_embed.proj = torch.nn.Sequential(
            torch.nn.Conv2d(in_chans, C // 2, 3, 2, 1),
            torch.nn.Conv2d(C // 2, C, 3, 2, 1))
        self.patch_embed.norm = torch.nn.LayerNorm(C)
        self.levels = torch.nn.ModuleList()
        for i, depth in enumerate(depths):
            level = torch.nn.Module()
            level.blocks = torch.nn.ModuleList(
                NATLayer(C * 2 ** i, num_heads[i], kernel_size,
                         dilations[i][j], mlp_ratio) for j in range(depth))
            level.downsample = ConvDownsampler(C * 2 ** i) \
                if i < len(depths) - 1 else None
            self.levels.append(level)
        self.norm = torch.nn.LayerNorm(C * 2 ** (len(depths) - 1))
        self.head = torch.nn.Linear(C * 2 ** (len(depths) - 1), num_classes)

    def forward(self, images):
        x = self.patch_embed.proj(images).permute(0, 2, 3, 1)
        x = self.patch_embed.norm(x)
        for level in self.levels:
            for layer in level.blocks:
                x = layer(x)
            if level.downsample is not None:
                x = level.downsample(x)
        return self.head(self.norm(x).flatten(1, 2).mean(1))
