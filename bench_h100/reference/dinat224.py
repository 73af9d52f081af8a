"""Plain reference of DiNAT (stnls_tpu_torch/models/dinat.py: DiNAT,
Hassani and Shi 2022, arXiv:2209.15001, the upstream
classification/dinat.py), in plain PyTorch and float32; it imports
nothing of the program or of JAX. The benchmark judges dinat224's runs by
it.

  * the ConvTokenizer, the NATLayers, the ConvDownsamplers and the head
    as the upstream model has them, by F.conv2d, F.linear and
    F.layer_norm on a dict of parameters;
  * neighborhood attention from NATTEN's rule, written here on its own:
    per axis of length L and dilation d, a query at i attends to the k
    members of its residue class r = i mod d starting at class index
    clamp(i // d - k // 2, 0, n - k), n the class's length; the
    relative-position bias rpb[h, k - 1 + (neighbour - query) / d] per
    axis; the keys and values read by index gathers, the logits and the
    value sum by einsum.

`outputs` runs the model a block of images at a time (the activations of
the whole batch would not fit the card beside the program's); the loss is
the mean cross-entropy over the whole batch. `judge` holds a run's
outputs to it:
  out_err    largest |logit - reference's|;
  loss_err   |loss - reference's| / reference's;
  grad_err   the worst parameter's |grad - reference's| (2-norm) over
             the larger of its reference norm and the median parameter's.
Nothing is selected, so no choice among near-ties is followed. With
round_tf32 every linear layer, conv and attention product (q with the
keys, the weights with the values) reads its operands rounded to TF32
(10 bits of mantissa), as the H100's tensor cores would: the control.
"""

import contextlib
import math

import torch
import torch.nn.functional as F_

# images a block in `outputs`
BLOCK = 8


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
    """{name: (shape, init)} of every parameter, by the upstream model's
    names; init is ("fan", fan-in) (uniform within 1/sqrt(fan-in)),
    ("table",) (uniform within 0.02), ("one",) or ("zero",) (a
    LayerNorm's weight and bias)."""
    C, k = cfg["embed_dim"], cfg["kernel_size"]
    hidden = lambda c: int(c * cfg["mlp_ratio"])  # noqa: E731
    shapes = {}

    def conv(name, c_out, c_in, bias=True):
        shapes[f"{name}.weight"] = ((c_out, c_in, 3, 3), ("fan", 9 * c_in))
        if bias:
            shapes[f"{name}.bias"] = ((c_out,), ("fan", 9 * c_in))

    def linear(name, c_out, c_in):
        shapes[f"{name}.weight"] = ((c_out, c_in), ("fan", c_in))
        shapes[f"{name}.bias"] = ((c_out,), ("fan", c_in))

    def norm(name, c):
        shapes[f"{name}.weight"] = ((c,), ("one",))
        shapes[f"{name}.bias"] = ((c,), ("zero",))

    conv("patch_embed.proj.0", C // 2, cfg["in_chans"])
    conv("patch_embed.proj.1", C, C // 2)
    norm("patch_embed.norm", C)
    n_levels = len(cfg["depths"])
    for i, depth in enumerate(cfg["depths"]):
        c = C * 2 ** i
        for j in range(depth):
            s = f"levels.{i}.blocks.{j}"
            norm(f"{s}.norm1", c)
            linear(f"{s}.attn.qkv", 3 * c, c)
            shapes[f"{s}.attn.rpb"] = ((cfg["num_heads"][i], 2 * k - 1,
                                        2 * k - 1), ("table",))
            linear(f"{s}.attn.proj", c, c)
            norm(f"{s}.norm2", c)
            linear(f"{s}.mlp.fc1", hidden(c), c)
            linear(f"{s}.mlp.fc2", c, hidden(c))
        if i < n_levels - 1:
            conv(f"levels.{i}.downsample.reduction", 2 * c, c, bias=False)
            norm(f"levels.{i}.downsample.norm", 2 * c)
    c = C * 2 ** (n_levels - 1)
    norm("norm", c)
    linear("head", cfg["num_classes"], c)
    return shapes


def neighborhood(L, k, d, device=None):
    """[L, k] the neighbours along one axis of each position, and [L, k]
    their relative-position bias index k - 1 + (neighbour - i) / d."""
    i = torch.arange(L, device=device)
    r, j = i % d, i // d
    n = (L - r + d - 1) // d
    start = torch.minimum((j - k // 2).clamp(min=0), n - k)
    cls = start[:, None] + torch.arange(k, device=device)
    return r[:, None] + d * cls, k - 1 + cls - j[:, None]


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

    def conv(self, x, name):
        """A 3x3 stride-2 conv with padding 1 on [B,C,H,W]."""
        x, w = self.operands(x, self.p[f"{name}.weight"])
        return F_.conv2d(x, w, self.p.get(f"{name}.bias"), 2, 1)

    def einsum(self, eq, a, b):
        return torch.einsum(eq, *self.operands(a, b))

    def norm(self, x, name):
        return F_.layer_norm(x, x.shape[-1:], self.p[f"{name}.weight"],
                             self.p[f"{name}.bias"])


def attention(o, x, pre, heads, k, d):
    """Dilated neighborhood attention of [B,H,W,C] (the module's
    docstring)."""
    B, H, W, C = x.shape
    Fh = C // heads
    q, key, v = o.linear(x, f"{pre}.qkv").reshape(B, H, W, 3, heads, Fh) \
        .unbind(3)                                     # [B,H,W,heads,Fh]
    q = q * Fh ** -0.5
    ny, by = neighborhood(H, k, d, x.device)
    nx, bx = neighborhood(W, k, d, x.device)

    def around(t):
        """[B,H,W,heads,Fh] -> [B,H,k(i),W,k(j),heads,Fh] at the
        neighbours."""
        return t[:, ny][:, :, :, nx]

    logits = o.einsum("byxnf,byixjnf->bnyxij", q, around(key))
    rpb = o.p[f"{pre}.rpb"]
    logits = logits + rpb[:, by[:, None, :, None], bx[None, :, None, :]][None]
    a = torch.softmax(logits.reshape(B, heads, H, W, k * k), -1)
    out = o.einsum("bnyxij,byixjnf->byxnf", a.reshape(logits.shape),
                   around(v))
    return o.linear(out.reshape(B, H, W, C), f"{pre}.proj")


def forward(images, o, cfg):
    """[B,in_chans,H,W] -> logits [B,num_classes]."""
    k = cfg["kernel_size"]
    x = o.conv(o.conv(images, "patch_embed.proj.0"), "patch_embed.proj.1")
    x = o.norm(x.permute(0, 2, 3, 1), "patch_embed.norm")
    n_levels = len(cfg["depths"])
    for i, depth in enumerate(cfg["depths"]):
        for j in range(depth):
            s = f"levels.{i}.blocks.{j}"
            x = x + attention(o, o.norm(x, f"{s}.norm1"), f"{s}.attn",
                              cfg["num_heads"][i], k, cfg["dilations"][i][j])
            h = F_.gelu(o.linear(o.norm(x, f"{s}.norm2"), f"{s}.mlp.fc1"))
            x = x + o.linear(h, f"{s}.mlp.fc2")
        if i < n_levels - 1:
            s = f"levels.{i}.downsample"
            x = o.conv(x.permute(0, 3, 1, 2), f"{s}.reduction")
            x = o.norm(x.permute(0, 2, 3, 1), f"{s}.norm")
    return o.linear(o.norm(x, "norm").flatten(1, 2).mean(1), "head")


def outputs(clip, params, cfg, mode, round_tf32=False, block=BLOCK):
    """The reference's run, `block` images at a time: "out" (the logits),
    in train mode "loss" (the mean cross-entropy) and "grads" (by
    parameter name)."""
    train = mode == "train"
    p = {n: t.detach().clone().requires_grad_(train)
         for n, t in params.items()}
    names = list(p)
    o = Ops(p, round_tf32)
    images, labels = clip["images"], clip["labels"]
    B = images.shape[0]
    outs, grads = [], None
    for b0 in range(0, B, block):
        sl = slice(b0, b0 + block)
        with torch.set_grad_enabled(train), no_tf32():
            out = forward(images[sl], o, cfg)
            if train:
                loss_b = F_.cross_entropy(out, labels[sl],
                                          reduction="sum") / B
                g = torch.autograd.grad(loss_b, [p[n] for n in names])
                grads = list(g) if grads is None else \
                    [a + c for a, c in zip(grads, g)]
        outs.append(out.detach())
        del out
    res = dict(out=torch.cat(outs))
    if train:
        res["loss"] = F_.cross_entropy(res["out"], labels)
        res["grads"] = dict(zip(names, grads))
    return res


def judge(clip, out, params, cfg, mode):
    """The numbers of a run's outputs against the float32 reference."""
    ref = outputs(clip, params, cfg, mode)
    nums = dict(out_err=float((out["out"] - ref["out"]).abs().max()))
    if mode == "train":
        nums["loss_err"] = float((out["loss"] - ref["loss"]).abs()
                                 / ref["loss"].abs())
        norms = {n: float(g.norm()) for n, g in ref["grads"].items()}
        median = sorted(norms.values())[len(norms) // 2]
        nums["grad_err"] = max(
            float((out["grads"][n] - g).norm()) / max(norms[n], median)
            for n, g in ref["grads"].items())
    return nums


def parameter_count(cfg):
    return sum(math.prod(shape) for shape, _ in
               parameter_shapes(cfg).values())
