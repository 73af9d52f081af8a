"""Plain reference of RVRT with Shifted-NLS alignment
(stnls_tpu_torch/models/rvrt.py: RVRT, Liang et al. 2022, task 006, with
the upstream stnls README's non-local search in place of the predicted
offsets), in plain PyTorch and float32; it imports nothing of the program
or of JAX. The benchmark judges rvrt256's runs by it, and the CPU tests
(tests/torch_port/test_torch_rvrt.py) hold the port to it at a small size.

  * Swin layers as explicit matmuls (q k^T, the relative position bias,
    the shift mask of -100, softmax, @ v), windows padded after the norm,
    clipped to the input's extent and shifted by half a window along the
    axes longer than it;
  * the flow composition f_ac = f_bc + warp(f_ab, f_bc), warp a bilinear
    read at the pixel plus the flow (x first) with zeros outside;
  * the search: for each (query frame, key frame) pair and head, the
    ws x ws lattice around the reflected centre query + flow, shifted to
    lie inside the frame, its "prod" distances (the query's channels times
    the key's bilinear read) and torch.topk;
  * the aggregation: softmax(dists / sqrt(head width)) over both key
    frames' candidates, the values read bilinearly at the offsets, summed
    over K and the two key frames.

`outputs` runs the model one clip of the batch at a time (each clip's
activations alone fit a card), with its own selection or, given a run's
selection, at the run's offsets and its own top-K around the run's flows:
the judge follows the run's choice among near-ties (28 sequential
alignments, ~10^7 selections a step) and the run's search centres, so
that a rounding of a flow that moves a centre across a pixel moves the
window on both sides. `judge` holds a run's outputs to it:
  out_err    largest |out - reference's|;
  loss_err   |loss - reference's| / reference's;
  grad_err   the worst parameter's |grad - reference's| (2-norm) over
             the larger of its reference norm and the median parameter's;
  dists_err  largest |dist - reference's own top-K dist| of the ranked
             dists, over every alignment;
  inds_err   largest |dist - reference's prod at the run's offsets|;
  flow_err   largest |flow - reference's| (pixels) of the flows that
             centred each alignment's search: composed from the inputs
             in the _1 branches, the mean of the _1 offsets in the _2.
With round_tf32 every linear layer, conv and attention matmul reads its
operands rounded to TF32 (10 bits of mantissa), as the H100's tensor
cores would, and so does each flow warp (the flows and the field it
reads): the control.
"""

import contextlib
import functools
import math

import torch
import torch.nn.functional as F_

BRANCHES = ("backward_1", "forward_1", "backward_2", "forward_2")
MASKED = -100.


def tf32(x):
    """x with its float32 operands rounded to TF32 (the gradient passes
    straight through)."""
    bits = x.detach().contiguous().view(torch.int32)
    r = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return x + (r - x.detach())


@contextlib.contextmanager
def no_tf32():
    """float32 matmuls and convs in float32 (TF32 off) inside, the flags
    as they were after."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def parameter_shapes(cfg):
    """{name: (shape, init)} of every parameter; init is ("fan", fan-in)
    (uniform within 1/sqrt(fan-in)), ("table",) (uniform within 0.02),
    ("one",) or ("zero",) (a LayerNorm's weight and bias)."""
    C, heads = cfg["embed_dim"], cfg["num_heads"]
    hidden = int(C * cfg["mlp_ratio"])
    g = cfg["inputconv_groups"]
    win = tuple(cfg["window_size"])
    frame_win = (1,) + win[1:]
    shapes = {}

    def layer(name, shape, fan):
        shapes[f"{name}.weight"] = (shape, ("fan", fan))
        shapes[f"{name}.bias"] = ((shape[0],), ("fan", fan))

    def conv(name, c_out, c_in, k, groups=1):
        layer(name, (c_out, c_in // groups) + k,
              c_in // groups * math.prod(k))

    def linear(name, c_out, c_in):
        layer(name, (c_out, c_in), c_in)

    def norm(name):
        shapes[f"{name}.weight"] = ((C,), ("one",))
        shapes[f"{name}.bias"] = ((C,), ("zero",))

    def rstb_conv(pre, c_in, groups, blocks, window):
        conv(f"{pre}.conv", C, c_in, (1, 3, 3), groups)
        norm(f"{pre}.norm_in")
        n_bias = (2 * window[0] - 1) * (2 * window[1] - 1) \
            * (2 * window[2] - 1)
        for b in range(blocks):
            for i in range(cfg["depth"]):
                s = f"{pre}.blocks.{b}.layers.{i}"
                norm(f"{s}.norm1")
                shapes[f"{s}.attn.relative_position_bias_table"] = \
                    ((n_bias, heads), ("table",))
                linear(f"{s}.attn.qkv", 3 * C, C)
                linear(f"{s}.attn.proj", C, C)
                norm(f"{s}.norm2")
                linear(f"{s}.fc11", hidden, C)
                linear(f"{s}.fc12", hidden, C)
                linear(f"{s}.fc2", C, hidden)
            linear(f"{pre}.blocks.{b}.linear", C, C)
        norm(f"{pre}.norm_out")

    conv("conv1", C, cfg["in_chans"], (1, 3, 3))
    conv("conv2", C, C, (1, 3, 3))
    rstb_conv("feat_extract", C, g[0], cfg["num_blocks"][0], frame_win)
    for b in BRANCHES:
        for n in "qkv":
            linear(f"align.{b}.{n}", 2 * C, C)
        linear(f"align.{b}.proj", C, 2 * C)
        linear(f"align.{b}.mlp1", 2 * C, C)
        linear(f"align.{b}.mlp2", C, 2 * C)
    for i, b in enumerate(BRANCHES):
        rstb_conv(f"backbone.{b}", (2 + i) * C, g[i + 1],
                  cfg["num_blocks"][1], win)
    rstb_conv("reconstruction", 5 * C, g[5], cfg["num_blocks"][2],
              frame_win)
    conv("conv_before_upsample", 64, C, (1, 1, 1))
    conv("upsample.0", 256, 64, (1, 3, 3))
    conv("upsample.1", 256, 64, (1, 3, 3))
    conv("conv_hr", 64, 64, (1, 3, 3))
    conv("conv_last", 3, 64, (1, 3, 3))
    return shapes


class Ops:
    """The parameterised operations on a dict of parameters, with or
    without TF32 operands."""

    def __init__(self, params, round_tf32=False):
        self.p, self.round = params, round_tf32

    def operands(self, *xs):
        return [tf32(x) for x in xs] if self.round else list(xs)

    def linear(self, x, name):
        x, w = self.operands(x, self.p[f"{name}.weight"])
        return F_.linear(x, w, self.p[f"{name}.bias"])

    def conv(self, x, name, stride=1, padding=0, groups=1):
        """A conv; a grouped one as one conv a group: PyTorch's grouped
        conv3d backward on the CPU gave early layers' gradients 6e-4 off
        a float64 run of this reference, its groups apart 7e-7."""
        x, w = self.operands(x, self.p[f"{name}.weight"])
        return torch.cat([F_.conv3d(xi, wi, bi, stride, padding)
                          for xi, wi, bi in zip(
                              x.chunk(groups, 1), w.chunk(groups, 0),
                              self.p[f"{name}.bias"].chunk(groups, 0))], 1)

    def matmul(self, a, b):
        a, b = self.operands(a, b)
        return a @ b

    def norm(self, x, name):
        return F_.layer_norm(x, x.shape[-1:], self.p[f"{name}.weight"],
                             self.p[f"{name}.bias"])


def _windows(x, win):
    """[B,D,H,W,C] -> [B * windows, N, C], windows in (d, h, w) order."""
    B, D, H, W, C = x.shape
    x = x.reshape(B, D // win[0], win[0], H // win[1], win[1], W // win[2],
                  win[2], C)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, math.prod(win), C)


def _unwindows(x, win, B, D, H, W):
    x = x.reshape(B, D // win[0], H // win[1], W // win[2], win[0], win[1],
                  win[2], -1)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(B, D, H, W, -1)


@functools.lru_cache(maxsize=None)
def _bias_index(window):
    """[N,N] the bias table row of each token pair of a window."""
    d, h, w = window
    pos = [(a, b, c) for a in range(d) for b in range(h) for c in range(w)]
    rows = [[((p[0] - q[0] + d - 1) * (2 * h - 1) + p[1] - q[1] + h - 1)
             * (2 * w - 1) + p[2] - q[2] + w - 1 for q in pos] for p in pos]
    return torch.tensor(rows)


def _mask(padded, win, shift, device):
    """[nW,N,N]: 0 within a region of the shifted extent, MASKED across."""
    region = torch.zeros(padded, dtype=torch.long)
    for axis in range(3):
        ids = torch.zeros(padded[axis], dtype=torch.long)
        if shift[axis]:
            ids[padded[axis] - win[axis]:padded[axis] - shift[axis]] = 1
            ids[padded[axis] - shift[axis]:] = 2
        shape = [1, 1, 1]
        shape[axis] = -1
        region = region * 3 + ids.reshape(shape)
    ids = _windows(region[None, ..., None], win)[..., 0]
    same = ids[:, :, None] == ids[:, None, :]
    return torch.where(same, 0., MASKED).to(device)


def swin_layer(o, x, pre, heads, window, shifted):
    """A Swin layer on [B,D,H,W,C]."""
    B, D, H, W, C = x.shape
    win, shift = [], []
    for n, w in zip((D, H, W), window):
        win.append(min(n, w))
        shift.append(w // 2 if shifted and n > w else 0)
    y = o.norm(x, f"{pre}.norm1")
    padded = [-(-n // w) * w for n, w in zip((D, H, W), win)]
    y = F_.pad(y, (0, 0, 0, padded[2] - W, 0, padded[1] - H, 0,
                   padded[0] - D))
    if any(shift):
        y = torch.roll(y, [-s for s in shift], (1, 2, 3))
    xw = _windows(y, win)
    Bw, N, _ = xw.shape
    Fh = C // heads
    qkv = o.linear(xw, f"{pre}.attn.qkv").reshape(Bw, N, 3, heads, Fh)
    q = qkv[:, :, 0].transpose(1, 2)
    k = qkv[:, :, 1].transpose(1, 2)
    v = qkv[:, :, 2].transpose(1, 2)
    attn = o.matmul(q * Fh ** -0.5, k.transpose(-2, -1))
    table = o.p[f"{pre}.attn.relative_position_bias_table"]
    index = _bias_index(tuple(window))[:N, :N].to(x.device)
    attn = attn + table[index].permute(2, 0, 1)[None]
    if any(shift):
        mask = _mask(padded, win, shift, x.device)
        attn = (attn.reshape(Bw // mask.shape[0], mask.shape[0], heads, N, N)
                + mask[:, None]).reshape(Bw, heads, N, N)
    attn = torch.softmax(attn, dim=-1)
    y = o.matmul(attn, v).transpose(1, 2).reshape(Bw, N, C)
    y = _unwindows(o.linear(y, f"{pre}.attn.proj"), win, B, *padded)
    if any(shift):
        y = torch.roll(y, shift, (1, 2, 3))
    x = x + y[:, :D, :H, :W]
    z = o.norm(x, f"{pre}.norm2")
    return x + o.linear(F_.gelu(o.linear(z, f"{pre}.fc11"))
                        * o.linear(z, f"{pre}.fc12"), f"{pre}.fc2")


def rstb_conv(o, x, pre, cfg, groups, blocks, window):
    """RSTBWithInputConv: [B,c_in,D,H,W] -> [B,D,H,W,C]."""
    x = o.conv(x, f"{pre}.conv", padding=(0, 1, 1), groups=groups)
    x = o.norm(x.permute(0, 2, 3, 4, 1), f"{pre}.norm_in")
    for b in range(blocks):
        y = x
        for i in range(cfg["depth"]):
            y = swin_layer(o, y, f"{pre}.blocks.{b}.layers.{i}",
                           cfg["num_heads"], window, i % 2 == 1)
        x = x + o.linear(y, f"{pre}.blocks.{b}.linear")
    return o.norm(x, f"{pre}.norm_out")


def inside(x, L):
    return (x >= 0) & (x <= L - 1)


def bilinear(x, ph, pw):
    """x [B,HD,F,H,W] read at float positions ph, pw [B,HD,h,w,K] ->
    [B,HD,F,h,w,K], corners outside the frame weighted 0."""
    B, HD, F, H, W = x.shape
    flat = x.reshape(B, HD, F, H * W)
    h0, w0 = torch.floor(ph), torch.floor(pw)
    out = 0.
    for di in (0, 1):
        for dj in (0, 1):
            hc, wc = h0 + di, w0 + dj
            wgt = (torch.clamp(1. - torch.abs(hc - ph), min=0.)
                   * torch.clamp(1. - torch.abs(wc - pw), min=0.))
            wgt = torch.where(inside(hc, H) & inside(wc, W), wgt,
                              torch.zeros_like(wgt))
            idx = (hc.clamp(0, H - 1) * W + wc.clamp(0, W - 1)).long()
            val = torch.gather(flat, 3, idx.reshape(B, HD, 1, -1)
                               .expand(B, HD, F, -1))
            out = out + wgt[:, :, None] * val.reshape((B, HD, F)
                                                      + ph.shape[2:])
    return out


def warp(x, flow):
    """x [N,C,H,W] read at each pixel plus flow [N,2,H,W] (x first),
    bilinearly, zeros outside."""
    N, C, H, W = x.shape
    hh = torch.arange(H, device=x.device, dtype=x.dtype)[:, None]
    ww = torch.arange(W, device=x.device, dtype=x.dtype)[None, :]
    ph = (hh + flow[:, 1])[:, None, :, :, None]
    pw = (ww + flow[:, 0])[:, None, :, :, None]
    return bilinear(x[:, None], ph, pw)[:, 0, ..., 0]


def reflect(x, L):
    x = torch.where(x < 0, -x, x)
    return torch.where(x > L - 1, 2 * (L - 1) - x, x)


def window_offset(ctr, ws, L):
    """Lattice points before the centre in its window of ws, shifted so
    that the whole window lies inside [0, L - 1]."""
    half = (ws - 1) // 2
    off = torch.full_like(ctr, float(half))
    off = torch.where(ctr - half < 0, torch.floor(ctr), off)
    last = ctr + ((ws - 1) - off)
    off = torch.where(last > L - 1, torch.ceil(ctr - (L - 1) + (ws - 1)),
                      off)
    return torch.round(off)


def prod_at(q, k, offs):
    """prod distances [B,HD,h,w,K] of the queries q [B,HD,F,h,w] against
    the keys k read at the offsets [B,HD,h,w,K,2] (dh, dw)."""
    B, HD, F, h, w = q.shape
    hh = torch.arange(h, device=q.device, dtype=q.dtype)[:, None, None]
    ww = torch.arange(w, device=q.device, dtype=q.dtype)[None, :, None]
    kb = bilinear(k, hh + offs[..., 0], ww + offs[..., 1])
    return (q[..., None] * kb).sum(2)


def own_topk(q, k, flow, ws, K):
    """The search's own top-K of one pair: queries q [B,HD,F,h,w], keys
    k, flow [B,2,h,w] (x first) -> (dists [B,HD,h,w,K] descending,
    offsets [B,HD,h,w,K,2]), without gradient."""
    B, HD, F, h, w = q.shape
    dev = q.device
    with torch.no_grad():
        hh = torch.arange(h, device=dev, dtype=q.dtype)[:, None]
        ww = torch.arange(w, device=dev, dtype=q.dtype)[None, :]
        ctr_h = reflect(hh + flow[:, 1], h)
        ctr_w = reflect(ww + flow[:, 0], w)
        off_h, off_w = window_offset(ctr_h, ws, h), window_offset(ctr_w, ws,
                                                                  w)
        cells = torch.arange(ws, device=dev, dtype=q.dtype)
        ph = (ctr_h - off_h)[..., None, None] + cells[:, None]
        pw = (ctr_w - off_w)[..., None, None] + cells[None, :]
        ph = ph.expand(B, h, w, ws, ws).reshape(B, 1, h, w, ws * ws)
        pw = pw.expand(B, h, w, ws, ws).reshape(B, 1, h, w, ws * ws)
        ok = inside(ph, h) & inside(pw, w)
        offs = torch.stack([ph - hh[..., None], pw - ww[..., None]], -1) \
            .expand(B, HD, h, w, ws * ws, 2)
        d = prod_at(q, k, offs)
        d = torch.where(ok, d, torch.full_like(d, -float("inf")))
        d, cell = torch.topk(d, K, dim=-1, largest=True, sorted=True)
        sel = torch.gather(offs, 4, cell[..., None].expand(-1, -1, -1, -1, -1,
                                                           2))
    return d, sel


def compose(o, flows, n):
    """[B,2(j),2(r),2,h,w] the flows of walk clip n from its query frame j
    to key frame j (r = 0) and 1 - j (r = 1) of clip n - 1; flows
    [B,T-1,2,h,w] at walk frame m + 1 into m."""
    f01, f12, f23 = (flows[:, 2 * n + d] for d in (-2, -1, 0))
    f02 = f12 + warp(*o.operands(f01, f12))
    f13 = f23 + warp(*o.operands(f12, f23))
    f03 = f23 + warp(*o.operands(f02, f23))
    return torch.stack([torch.stack([f02, f12], 1),
                        torch.stack([f13, f03], 1)], 1)


def align(o, pre, f_q, f_k, p, flows, cfg, given, record):
    """One alignment: f_q, f_k, p [B,2,h,w,C], flows [B,2,2,2,h,w] ->
    (aligned [B,2,h,w,C], updated flows [B,2,2,2,h,w]). At the offsets
    of `given` (the run's selection, {"dists", "inds", "flows"}) when
    given, its own top-K around the run's flows; else at its own top-K
    around `flows`. Appends its top-K, the prods at the offsets it used
    and its own flows to `record`."""
    B, _, h, w, C = f_q.shape
    HD = cfg["attention_heads"]
    Fh = 2 * C // HD

    def heads(x, j):
        return x[:, j].reshape(B, h, w, HD, Fh).permute(0, 3, 4, 1, 2)

    q, k, v = (o.linear(x, f"{pre}.{n}") for x, n in
               ((f_q, "q"), (f_k, "k"), (p, "v")))
    rec = dict(dists=[], inds=[], prods=[])
    centres = flows if given is None else given["flows"]
    out, upd = [], []
    for j in (0, 1):
        logits, offsets, keys = [], [], []
        for r in (0, 1):
            kf = j if r == 0 else 1 - j
            qh, kh = heads(q, j), heads(k, kf)
            d_own, o_own = own_topk(qh, kh, centres[:, j, r], cfg["ws"],
                                    cfg["K"])
            offs = o_own if given is None else given["inds"][:, j, r]
            d = prod_at(qh, kh, offs)
            rec["dists"].append(d_own)
            rec["inds"].append(o_own)
            rec["prods"].append(d.detach())
            logits.append(d / math.sqrt(Fh))
            offsets.append(offs)
            keys.append(kf)
            upd.append(offs.mean((1, 4)).flip(-1).permute(0, 3, 1, 2))
        wts = torch.softmax(torch.cat(logits, -1), dim=-1)
        K = logits[0].shape[-1]
        hh = torch.arange(h, device=q.device, dtype=q.dtype)[:, None, None]
        ww = torch.arange(w, device=q.device, dtype=q.dtype)[None, :, None]
        acc = 0.
        for r in (0, 1):
            vb = bilinear(heads(v, keys[r]), hh + offsets[r][..., 0],
                          ww + offsets[r][..., 1])
            acc = acc + (vb * wts[:, :, None, ..., r * K:(r + 1) * K]).sum(-1)
        out.append(acc.reshape(B, 2 * C, h, w).permute(0, 2, 3, 1))
    record.append(dict({key: torch.stack(vals, 1).reshape(
        (B, 2, 2) + vals[0].shape[1:]) for key, vals in rec.items()},
        flows=flows.detach()))
    o_ = o.linear(torch.stack(out, 1), f"{pre}.proj")
    o_ = o_ + o.linear(F_.gelu(o.linear(o_, f"{pre}.mlp1")), f"{pre}.mlp2")
    upd = torch.stack(upd, 1).reshape(B, 2, 2, 2, h, w).detach()
    return o_, upd


def forward(clip, o, cfg, given=None, record=None):
    """The denoised clips [B,T,3,H,W] of clip["lq"] [B,T,4,H,W]. `given`:
    a run's selections in order (or None: the reference's own); the
    alignments append to `record`."""
    lq = clip["lq"]
    B, T = lq.shape[:2]
    record = [] if record is None else record
    given = iter(given) if given is not None else None
    win = tuple(cfg["window_size"])
    frame_win = (1,) + win[1:]
    g = cfg["inputconv_groups"]
    x = F_.leaky_relu(o.conv(lq.transpose(1, 2), "conv1", (1, 2, 2),
                             (0, 1, 1)), 0.1)
    x = F_.leaky_relu(o.conv(x, "conv2", (1, 2, 2), (0, 1, 1)), 0.1)
    feats = {"shallow": rstb_conv(o, x, "feat_extract", cfg, g[0],
                                  cfg["num_blocks"][0], frame_win)}
    updated = {}
    for i, b in enumerate(BRANCHES):
        back = b.startswith("backward")
        walk = [f.flip(1) if back else f for f in feats.values()]
        flows = clip["fflow"].flip(1) if back else clip["bflow"]
        prev = walk[-1]
        p, outs, upd_b = None, [], []
        for n in range(T // 2):
            c, c0 = slice(2 * n, 2 * n + 2), slice(2 * n - 2, 2 * n)
            if n == 0:
                a = torch.zeros_like(prev[:, c])
            else:
                fl = compose(o, flows, n) if b.endswith("_1") \
                    else updated[b.replace("_2", "_1")][n - 1]
                a, u = align(o, f"align.{b}", prev[:, c], prev[:, c0], p, fl,
                             cfg, None if given is None else next(given),
                             record)
                upd_b.append(u)
            xin = torch.cat([f[:, c] for f in walk] + [a], -1)
            p = a + rstb_conv(o, xin.permute(0, 4, 1, 2, 3), f"backbone.{b}",
                              cfg, g[i + 1], cfg["num_blocks"][1], win)
            outs.append(p)
        updated[b] = upd_b
        out = torch.cat(outs, 1)
        feats[b] = out.flip(1) if back else out
    hr = rstb_conv(o, torch.cat(list(feats.values()), -1)
                   .permute(0, 4, 1, 2, 3), "reconstruction", cfg, g[5],
                   cfg["num_blocks"][2], frame_win)
    hr = F_.leaky_relu(o.conv(hr.permute(0, 4, 1, 2, 3),
                              "conv_before_upsample"), 0.1)
    for i in range(2):
        hr = o.conv(hr, f"upsample.{i}", padding=(0, 1, 1))
        hr = F_.pixel_shuffle(hr.transpose(1, 2), 2).transpose(1, 2)
        hr = F_.leaky_relu(hr, 0.1)
    hr = o.conv(o.conv(hr, "conv_hr", padding=(0, 1, 1)), "conv_last",
                padding=(0, 1, 1))
    return hr.transpose(1, 2) + lq[:, :, :3]


def outputs(clip, params, cfg, mode, selections=None, round_tf32=False):
    """The reference's run, one clip of the batch at a time: "out", in
    train mode "loss" and "grads" (by parameter name), and "align": each
    alignment's {"dists", "inds"} (its own selection, in the program's
    layout [B,2(j),2(r),HD,h,w,K(,2)]), "prods" (the prods at the
    offsets it used: the run's when `selections` is given) and "flows"
    (its own, [B,2(j),2(r),2,h,w])."""
    train = mode == "train"
    p = {n: t.detach().clone().requires_grad_(train)
         for n, t in params.items()}
    names = list(p)
    o = Ops(p, round_tf32)
    B = clip["lq"].shape[0]
    n_all = clip["clean"].numel()
    outs, records, grads = [], [], None
    for b in range(B):
        one = {k: v[b:b + 1] for k, v in clip.items()}
        given = None if selections is None else \
            [{k: s[k][b:b + 1] for k in ("dists", "inds", "flows")}
             for s in selections]
        record = []
        with torch.set_grad_enabled(train), no_tf32():
            out = forward(one, o, cfg, given, record)
            if train:
                loss_b = (out - one["clean"]).pow(2).sum() / n_all
                g = torch.autograd.grad(loss_b, [p[n] for n in names])
                grads = list(g) if grads is None else \
                    [a + c for a, c in zip(grads, g)]
        outs.append(out.detach())
        records.append(record)
        del out
    res = dict(out=torch.cat(outs), align=[
        {k: torch.cat([r[i][k] for r in records]) for k in records[0][i]}
        for i in range(len(records[0]))])
    if train:
        # the mean of the whole batch, on a contiguous tensor: the
        # program's reduction, so the loss differs only where out does
        res["loss"] = (res["out"].contiguous() - clip["clean"]).pow(2).mean()
        res["grads"] = dict(zip(names, grads))
    return res


def judge(clip, out, params, cfg, mode):
    """The numbers of a run's outputs against the float32 reference at the
    run's own selection."""
    ref = outputs(clip, params, cfg, mode, selections=out["align"])
    nums = dict(out_err=float((out["out"] - ref["out"]).abs().max()))
    if mode == "train":
        nums["loss_err"] = float((out["loss"] - ref["loss"]).abs()
                                 / ref["loss"].abs())
        norms = {n: float(g.norm()) for n, g in ref["grads"].items()}
        median = sorted(norms.values())[len(norms) // 2]
        nums["grad_err"] = max(
            float((out["grads"][n] - g).norm()) / max(norms[n], median)
            for n, g in ref["grads"].items())
    nums["dists_err"] = max(float((s["dists"] - r["dists"]).abs().max())
                            for s, r in zip(out["align"], ref["align"]))
    nums["inds_err"] = max(float((s["dists"] - r["prods"]).abs().max())
                           for s, r in zip(out["align"], ref["align"]))
    nums["flow_err"] = max(float((s["flows"] - r["flows"]).abs().max())
                           for s, r in zip(out["align"], ref["align"]))
    return nums
