"""RVRT with Shifted-NLS alignment: the recurrent video-denoising
transformer (Liang et al., "Recurrent Video Restoration Transformer with
Guided Deformable Attention", NeurIPS 2022, arXiv:2206.02146; its
`models/network_rvrt.py`, task 006_RVRT_videodenoising_DAVIS_16frames)
with the offsets that its guided deformable attention predicts replaced by
a flow-guided non-local search: the upstream stnls README's "RVRT upgrade"
(a 9x9 window around the flow, one frame searched per flow, K 9).

    out = RVRT(...)(lq, fflow, bflow)

lq [B,T,4,H,W]: the noisy RGB frames and a noise-level map (non-blind);
out [B,T,3,H,W]. The flows are inputs at the feature scale (H/4, W/4),
[B,T-1,2,H/4,W/4] with x first: fflow[:, i] at frame i points into frame
i + 1, bflow[:, i] at frame i + 1 into frame i (SpyNet, which computes
them upstream, is not part of this module).

The network, all float32:
  * shallow features at 1/4 scale: two stride-2 (1,3,3) convs with
    LeakyReLU(0.1), then an RSTBWithInputConv (window (1, wh, ww));
  * four propagation branches, backward_1, forward_1, backward_2,
    forward_2, each walking the clips of 2 frames (RVRT's clip_size; a
    backward branch last to first, each clip's frames flipped); before each
    clip but the first, `Align` takes the queries from the clip's features of
    the branch run before (the shallow features for backward_1), the keys
    from the previous clip's, and the values from the propagated feature
    p; then p = aligned + backbone(cat(shallow, earlier branches, aligned));
  * reconstruction: an RSTBWithInputConv over the five features, a 1x1x1
    conv to 64 channels, two (conv to 256, PixelShuffle 2) steps back to
    full size, two (1,3,3) convs, plus the noisy frames.

`Align` is guided deformable attention with the upgrade: for each of the
clip's two query frames and each of the previous clip's two key frames,
PairedSearch (ws, ps 1, K, prod distances, float offsets) around the
flow, the four (query frame, key frame) pairs stacked on the batch axis
so that one call searches them all (on the card one launch of the search
kernel B1, of its backward B2 and of the geometry kernel G1); a softmax
of dists / sqrt(head width) over both key frames' 2K candidates; the
values gathered by NonLocalGather (ps 1) from the key frame as a one-frame
video (B3, backward B4) and summed over K and the two key frames; then a
projection and an MLP. In the _1 branches the flows to frame j and 1 - j
of the previous clip are composed from adjacent flows as RVRT composes
them (f_ac = f_bc + warp(f_ab, f_bc), RVRT's `flow_warp`); the _2
branches take the updated flows of the same clip's _1 alignment: the mean
over heads and K of the offsets found to each key frame, (dh, dw) flipped
to (x, y), without gradient (the search's offsets follow the flows,
which are inputs).

The window attention runs as explicit float32 matmuls (q k^T, relative
position bias, the shift mask, softmax, @ v), not a fused attention
kernel: the same arithmetic as the plain reference
(bench_h100/reference/rvrt256.py). Spans: stnls.rvrt.swin
around each Swin layer, stnls.rvrt.align around each Align,
stnls.rvrt.flow around the flow composition; `Align.calls` counts the
alignments (4 * (T / 2 - 1) a forward).
"""

import math

import torch
import torch.nn.functional as F_

from stnls_tpu_torch.agg.gather import NonLocalGather
from stnls_tpu_torch.search.paired_search import PairedSearch
from stnls_tpu_torch.utils.spans import span

BRANCHES = ("backward_1", "forward_1", "backward_2", "forward_2")
# the clip's (query frame j, key frame of the previous clip) pairs of one
# alignment, in the order they are stacked on the batch axis: key r = 0 is
# frame j, r = 1 frame 1 - j
PAIR_QUERY = (0, 0, 1, 1)
PAIR_KEY = (0, 1, 1, 0)
# the shift mask's logit for a pair of tokens from different regions
MASKED = -100.


def window_size_for(x_size, window, shift):
    """The window and shift of an input of extent x_size: an axis no
    longer than its window takes the whole extent and no shift."""
    win, sh = list(window), list(shift)
    for i, n in enumerate(x_size):
        if n <= window[i]:
            win[i], sh[i] = n, 0
    return tuple(win), tuple(sh)


def window_partition(x, win):
    """[B,D,H,W,C] (each extent a multiple of win) -> [B*nW, N, C]."""
    B, D, H, W, C = x.shape
    x = x.view(B, D // win[0], win[0], H // win[1], win[1], W // win[2],
               win[2], C)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, math.prod(win), C)


def window_reverse(windows, win, B, D, H, W):
    """[B*nW, N, C] -> [B,D,H,W,C]."""
    x = windows.view(B, D // win[0], H // win[1], W // win[2], win[0],
                     win[1], win[2], -1)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(B, D, H, W, -1)


def relative_position_index(window):
    """[N,N] index into the (2wd-1)(2wh-1)(2ww-1) bias table of a window's
    token pairs (Swin's)."""
    coords = torch.stack(torch.meshgrid(
        *[torch.arange(w) for w in window], indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0)
    rel = rel + torch.tensor([w - 1 for w in window])
    rel[..., 0] *= (2 * window[1] - 1) * (2 * window[2] - 1)
    rel[..., 1] *= 2 * window[2] - 1
    return rel.sum(-1)


_MASKS = {}


def shift_mask(padded, win, shift, device):
    """[nW,N,N] Swin's mask of a cyclic shift over a padded extent: 0 for
    two tokens of one region, MASKED for two of different regions."""
    key = (tuple(padded), win, shift, str(device))
    if key not in _MASKS:
        img = torch.zeros((1,) + tuple(padded) + (1,), device=device)
        cnt = 0
        for d in (slice(-win[0]), slice(-win[0], -shift[0]),
                  slice(-shift[0], None)):
            for h in (slice(-win[1]), slice(-win[1], -shift[1]),
                      slice(-shift[1], None)):
                for w in (slice(-win[2]), slice(-win[2], -shift[2]),
                          slice(-shift[2], None)):
                    img[:, d, h, w, :] = cnt
                    cnt += 1
        ids = window_partition(img, win).squeeze(-1)
        diff = ids[:, None, :] - ids[:, :, None]
        _MASKS[key] = torch.where(diff != 0, MASKED, 0.)
    return _MASKS[key]


class WindowAttention(torch.nn.Module):
    """Multi-head self-attention inside a window with a learned relative
    position bias, as explicit matmuls."""

    def __init__(self, dim, window, heads):
        super().__init__()
        self.heads = heads
        self.scale = (dim // heads) ** -0.5
        self.qkv = torch.nn.Linear(dim, 3 * dim)
        self.proj = torch.nn.Linear(dim, dim)
        self.relative_position_bias_table = torch.nn.Parameter(torch.zeros(
            (2 * window[0] - 1) * (2 * window[1] - 1) * (2 * window[2] - 1),
            heads))
        self.register_buffer("relative_position_index",
                             relative_position_index(window),
                             persistent=False)

    def forward(self, x, mask=None):
        Bw, N, C = x.shape
        qkv = self.qkv(x).reshape(Bw, N, 3, self.heads, C // self.heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        attn = (q * self.scale) @ k.transpose(-2, -1)
        index = self.relative_position_index[:N, :N].reshape(-1)
        bias = self.relative_position_bias_table[index].reshape(N, N, -1)
        attn = attn + bias.permute(2, 0, 1)[None]
        if mask is not None:
            nW = mask.shape[0]
            attn = attn.view(Bw // nW, nW, self.heads, N, N) \
                + mask[:, None, :N, :N]
            attn = attn.view(Bw, self.heads, N, N)
        attn = torch.softmax(attn, dim=-1)
        return self.proj((attn @ v).transpose(1, 2).reshape(Bw, N, C))


class SwinLayer(torch.nn.Module):
    """A 3D Swin layer (RVRT's STL) on [B,D,H,W,C]: window attention, then
    a GEGLU MLP of width mlp_ratio * dim, each after a LayerNorm and
    added to its input. The windows are padded to whole windows after the
    norm; with `shifted` the input is rolled by half a window along every
    axis longer than its window, under Swin's mask."""

    def __init__(self, dim, heads, window, shifted, mlp_ratio):
        super().__init__()
        self.window = tuple(window)
        self.shift = tuple(w // 2 for w in window) if shifted else (0, 0, 0)
        self.norm1 = torch.nn.LayerNorm(dim)
        self.attn = WindowAttention(dim, window, heads)
        self.norm2 = torch.nn.LayerNorm(dim)
        hidden = int(dim * mlp_ratio)
        self.fc11 = torch.nn.Linear(dim, hidden)
        self.fc12 = torch.nn.Linear(dim, hidden)
        self.fc2 = torch.nn.Linear(hidden, dim)

    def forward(self, x):
        with span("stnls.rvrt.swin"):
            B, D, H, W, C = x.shape
            win, shift = window_size_for((D, H, W), self.window, self.shift)
            y = self.norm1(x)
            pads = [(w - n % w) % w for n, w in zip((D, H, W), win)]
            y = F_.pad(y, (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]))
            padded = y.shape[1:4]
            mask = None
            if any(shift):
                y = torch.roll(y, [-s for s in shift], dims=(1, 2, 3))
                mask = shift_mask(padded, win, shift, x.device)
            y = self.attn(window_partition(y, win), mask)
            y = window_reverse(y, win, B, *padded)
            if any(shift):
                y = torch.roll(y, list(shift), dims=(1, 2, 3))
            x = x + y[:, :D, :H, :W]
            z = self.norm2(x)
            return x + self.fc2(F_.gelu(self.fc11(z)) * self.fc12(z))


class RSTB(torch.nn.Module):
    """x + Linear(layers(x)): `depth` Swin layers, every second shifted."""

    def __init__(self, dim, heads, window, depth, mlp_ratio):
        super().__init__()
        self.layers = torch.nn.ModuleList(
            SwinLayer(dim, heads, window, i % 2 == 1, mlp_ratio)
            for i in range(depth))
        self.linear = torch.nn.Linear(dim, dim)

    def forward(self, x):
        y = x
        for layer in self.layers:
            y = layer(y)
        return x + self.linear(y)


def grouped_conv(conv, x):
    """A grouped Conv3d as one ungrouped conv a group: the same sums. On
    the H100 a step of rvrt256 takes 1.90 -> 1.75 s (cuDNN's float32
    kernels for one grouped conv are slower than for its groups apart),
    and on the CPU PyTorch's grouped conv3d backward left early layers'
    gradients 6e-4 off a float64 run, its groups apart 7e-7."""
    g = conv.groups
    if g == 1:
        return conv(x)
    return torch.cat([F_.conv3d(xi, wi, bi, conv.stride, conv.padding)
                      for xi, wi, bi in zip(x.chunk(g, 1),
                                            conv.weight.chunk(g, 0),
                                            conv.bias.chunk(g, 0))], 1)


class RSTBWithInputConv(torch.nn.Module):
    """A (1,3,3) grouped conv from c_in to dim channels, a LayerNorm,
    `blocks` RSTBs and a LayerNorm: [B,c_in,D,H,W] -> [B,D,H,W,dim]."""

    def __init__(self, c_in, groups, blocks, dim, heads, window, depth,
                 mlp_ratio):
        super().__init__()
        self.conv = torch.nn.Conv3d(c_in, dim, (1, 3, 3), padding=(0, 1, 1),
                                    groups=groups)
        self.norm_in = torch.nn.LayerNorm(dim)
        self.blocks = torch.nn.ModuleList(
            RSTB(dim, heads, window, depth, mlp_ratio)
            for _ in range(blocks))
        self.norm_out = torch.nn.LayerNorm(dim)

    def forward(self, x):
        x = self.norm_in(grouped_conv(self.conv, x).permute(0, 2, 3, 4, 1))
        for block in self.blocks:
            x = block(x)
        return self.norm_out(x)


def flow_warp(x, flow):
    """RVRT's flow_warp: x [N,C,H,W] read bilinearly at the pixel grid
    plus flow [N,2,H,W] (x first), zeros outside (grid_sample,
    align_corners=True)."""
    _, _, H, W = x.shape
    hh = torch.arange(H, device=x.device, dtype=x.dtype)[:, None]
    ww = torch.arange(W, device=x.device, dtype=x.dtype)[None, :]
    grid = torch.stack([2. * (ww + flow[:, 0]) / max(W - 1, 1) - 1.,
                        2. * (hh + flow[:, 1]) / max(H - 1, 1) - 1.], -1)
    return F_.grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                          align_corners=True)


def compose_flows(flows, n):
    """The flows of clip n (n >= 1) of a walk, from each of its query
    frames j to key frame j and 1 - j of clip n - 1, [B,2(j),2(r),2,h,w]
    (r = 0: key frame j), composed from adjacent flows as RVRT composes
    them. flows [B,T-1,2,h,w]: flows[:, m] at walk frame m + 1 into walk
    frame m."""
    with span("stnls.rvrt.flow"):
        f01, f12, f23 = (flows[:, 2 * n + d] for d in (-2, -1, 0))
        f02 = f12 + flow_warp(f01, f12)
        f13 = f23 + flow_warp(f12, f23)
        f03 = f23 + flow_warp(f02, f23)
        return torch.stack([torch.stack([f02, f12], 1),
                            torch.stack([f13, f03], 1)], 1)


class Align(torch.nn.Module):
    """Guided deformable attention with Shifted-NLS offsets (see the
    module's docstring). `Align.calls` counts the calls."""

    calls = 0

    def __init__(self, dim, heads, ws, k):
        super().__init__()
        self.heads = heads
        self.head_dim = 2 * dim // heads
        self.q = torch.nn.Linear(dim, 2 * dim)
        self.k = torch.nn.Linear(dim, 2 * dim)
        self.v = torch.nn.Linear(dim, 2 * dim)
        self.proj = torch.nn.Linear(2 * dim, dim)
        self.mlp1 = torch.nn.Linear(dim, 2 * dim)
        self.mlp2 = torch.nn.Linear(2 * dim, dim)
        self.search = PairedSearch(ws, ps=1, k=k, nheads=heads,
                                   dist_type="prod", stride0=1, stride1=1,
                                   itype="float")
        self.gather = NonLocalGather(ps=1, stride0=1, itype="float")

    def forward(self, f_q, f_k, p, flows, selections=None):
        """f_q, f_k, p [B,2,h,w,C] (the clip's features, the previous
        clip's, the previous clip's propagated feature); flows
        [B,2(j),2(r),2,h,w] -> (aligned [B,2,h,w,C], the updated flows
        [B,2,2,2,h,w]). With a list `selections`, appends the search's
        dists and offsets, [B,2(j),2(r),HD,h,w,K(,2)], and the flows that
        centred it, detached."""
        Align.calls += 1
        with span("stnls.rvrt.align"):
            B, _, h, w, C = f_q.shape
            HD, Fh = self.heads, self.head_dim

            def pairs(x, frames):
                """[B,2,h,w,D] -> [4B,D,h,w], the pairs' frames."""
                x = x.permute(1, 0, 4, 2, 3)
                return x[list(frames)].reshape(4 * B, -1, h, w)

            q = pairs(self.q(f_q), PAIR_QUERY)
            k = pairs(self.k(f_k), PAIR_KEY)
            v = pairs(self.v(p), PAIR_KEY)
            fl = flows.reshape(B, 4, 2, h, w).transpose(0, 1) \
                .reshape(4 * B, 2, h, w)
            dists, inds = self.search(q, k, fl)  # [4B,HD,h,w,K(,2)]
            K = dists.shape[-1]
            # one softmax over both key frames' candidates of a query
            logits = (dists / math.sqrt(Fh)).reshape(2, 2, B, HD, h, w, K)
            wts = torch.softmax(logits.permute(0, 2, 3, 4, 5, 1, 6)
                                .reshape(2, B, HD, h, w, 2 * K), dim=-1)
            wts = wts.reshape(2, B, HD, h, w, 2, K) \
                .permute(0, 5, 1, 2, 3, 4, 6).reshape(4 * B, HD, 1, h, w, K)
            offs = torch.cat([torch.zeros_like(inds[..., :1]), inds], -1)
            stack = self.gather(v.reshape(4 * B, HD, 1, Fh, h, w), wts,
                                offs[:, :, None])  # [4B,HD,K,1,Fh,h,w]
            agg = stack.sum(2).reshape(2, 2, B, HD * Fh, h, w).sum(1)
            o = self.proj(agg.permute(1, 0, 3, 4, 2))
            o = o + self.mlp2(F_.gelu(self.mlp1(o)))
            with torch.no_grad():
                upd = inds.mean((1, 4)).flip(-1).permute(0, 3, 1, 2)
                upd = upd.reshape(2, 2, B, 2, h, w).permute(2, 0, 1, 3, 4, 5)
            if selections is not None:
                selections.append(dict(
                    dists=dists.detach().reshape(2, 2, B, HD, h, w, K)
                    .permute(2, 0, 1, 3, 4, 5, 6),
                    inds=inds.detach().reshape(2, 2, B, HD, h, w, K, 2)
                    .permute(2, 0, 1, 3, 4, 5, 6, 7),
                    flows=flows.detach()))
            return o, upd


class RVRT(torch.nn.Module):
    """RVRT for video denoising with Shifted-NLS alignment (see the
    module's docstring). Widths are RVRT's task 006 by default."""

    def __init__(self, in_chans=4, embed_dim=192, num_heads=6,
                 window_size=(2, 8, 8), num_blocks=(1, 2, 1), depth=2,
                 mlp_ratio=2., inputconv_groups=(1, 3, 4, 6, 8, 4),
                 attention_heads=12, ws=9, k=9):
        super().__init__()
        C = embed_dim
        g = inputconv_groups
        frame_window = (1,) + tuple(window_size[1:])
        swin = dict(dim=C, heads=num_heads, depth=depth,
                    mlp_ratio=mlp_ratio)
        self.conv1 = torch.nn.Conv3d(in_chans, C, (1, 3, 3), (1, 2, 2),
                                     (0, 1, 1))
        self.conv2 = torch.nn.Conv3d(C, C, (1, 3, 3), (1, 2, 2), (0, 1, 1))
        self.feat_extract = RSTBWithInputConv(C, g[0], num_blocks[0],
                                              window=frame_window, **swin)
        self.align = torch.nn.ModuleDict(
            {b: Align(C, attention_heads, ws, k) for b in BRANCHES})
        self.backbone = torch.nn.ModuleDict(
            {b: RSTBWithInputConv((2 + i) * C, g[i + 1], num_blocks[1],
                                  window=tuple(window_size), **swin)
             for i, b in enumerate(BRANCHES)})
        self.reconstruction = RSTBWithInputConv(
            5 * C, g[5], num_blocks[2], window=frame_window, **swin)
        self.conv_before_upsample = torch.nn.Conv3d(C, 64, 1)
        self.upsample = torch.nn.ModuleList(
            torch.nn.Conv3d(64, 256, (1, 3, 3), padding=(0, 1, 1))
            for _ in range(2))
        self.conv_hr = torch.nn.Conv3d(64, 64, (1, 3, 3), padding=(0, 1, 1))
        self.conv_last = torch.nn.Conv3d(64, 3, (1, 3, 3), padding=(0, 1, 1))

    def propagate(self, feats, branch, flows, updated, selections):
        """One branch over features in its walk order, {name:
        [B,T,h,w,C]} (the branch run before last); flows [B,T-1,2,h,w] at
        walk frame m + 1 into m; `updated`, the _1 branch's updated flows
        by clip, for a _2 branch. Returns the branch's features [B,T,h,w,C]
        and, for a _1 branch, its updated flows by clip."""
        F_prev = list(feats.values())[-1]
        B, T, h, w, C = F_prev.shape
        p, out, upd_out = None, [], []
        for n in range(T // 2):
            c, c0 = slice(2 * n, 2 * n + 2), slice(2 * n - 2, 2 * n)
            if n == 0:
                a = F_prev.new_zeros((B, 2, h, w, C))
            else:
                fl = compose_flows(flows, n) if updated is None \
                    else updated[n - 1]
                a, upd = self.align[branch](F_prev[:, c], F_prev[:, c0], p,
                                            fl, selections)
                upd_out.append(upd)
            x = torch.cat([f[:, c] for f in feats.values()] + [a], -1)
            p = a + self.backbone[branch](x.permute(0, 4, 1, 2, 3))
            out.append(p)
        return torch.cat(out, 1), upd_out

    def forward(self, lq, fflow, bflow, selections=None):
        """lq [B,T,in_chans,H,W] (noisy RGB first), fflow/bflow
        [B,T-1,2,H/4,W/4] -> [B,T,3,H,W]. With a list `selections`, each
        alignment appends its search's dists, offsets and flows (Align)."""
        T = lq.shape[1]
        if T % 2:
            raise ValueError(f"T = {T}: RVRT walks clips of 2 frames")
        x = F_.leaky_relu(self.conv1(lq.transpose(1, 2)), 0.1)
        x = F_.leaky_relu(self.conv2(x), 0.1)
        feats = {"shallow": self.feat_extract(x)}
        updated = {}
        for branch in BRANCHES:
            back = branch.startswith("backward")
            walk = {k: f.flip(1) if back else f for k, f in feats.items()}
            out, upd = self.propagate(
                walk, branch, fflow.flip(1) if back else bflow,
                updated.get(branch.replace("_2", "_1")) if
                branch.endswith("_2") else None, selections)
            updated[branch] = upd
            feats[branch] = out.flip(1) if back else out
        hr = self.reconstruction(torch.cat(list(feats.values()), -1)
                                 .permute(0, 4, 1, 2, 3))
        hr = F_.leaky_relu(self.conv_before_upsample(
            hr.permute(0, 4, 1, 2, 3)), 0.1)
        for conv in self.upsample:
            hr = F_.pixel_shuffle(conv(hr).transpose(1, 2), 2).transpose(1, 2)
            hr = F_.leaky_relu(hr, 0.1)
        hr = self.conv_last(self.conv_hr(hr))
        return hr.transpose(1, 2) + lq[:, :, :3]
