"""Plain reference of DiNAT (stnls_tpu_torch/models/dinat.py) for the CPU
tests: plain torch in float32 (TF32 off from import on), on a dict of
parameters named as the model's. It imports nothing of stnls_tpu_torch,
of stnls_tpu or of JAX.

Its neighborhood is NATTEN's rule, written here on its own: per axis of
length L and dilation d, a query at i attends to the k members of its
residue class r = i mod d from class index clamp(i // d - k // 2, 0,
n - k), n the class's length, with the relative-position bias
rpb[h, k - 1 + (neighbour - i) / d] per axis; the keys and values are
read by index gathers, the logits and the value sum taken by einsum.
"""

import torch
import torch.nn.functional as F_

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def neighborhood(L, k, d):
    """([L, k] the neighbours along one axis of each position, [L, k]
    their bias index k - 1 + (neighbour - i) / d)."""
    i = torch.arange(L)
    r, j = i % d, i // d
    n = (L - r + d - 1) // d
    start = torch.minimum((j - k // 2).clamp(min=0), n - k)
    cls = start[:, None] + torch.arange(k)
    return r[:, None] + d * cls, k - 1 + cls - j[:, None]


def attention(p, x, pre, heads, k, d):
    """Dilated neighborhood attention of [B,H,W,C] with the parameters
    p[f"{pre}.qkv.weight"] ... p[f"{pre}.proj.bias"]."""
    B, H, W, C = x.shape
    Fh = C // heads
    qkv = F_.linear(x, p[f"{pre}.qkv.weight"], p[f"{pre}.qkv.bias"])
    q, key, v = qkv.reshape(B, H, W, 3, heads, Fh).unbind(3)
    q = q * Fh ** -0.5
    ny, by = neighborhood(H, k, d)
    nx, bx = neighborhood(W, k, d)
    kn = key[:, ny][:, :, :, nx]                     # [B,H,k,W,k,heads,Fh]
    logits = torch.einsum("byxnf,byixjnf->bnyxij", q, kn)
    logits = logits + p[f"{pre}.rpb"][:, by[:, None, :, None],
                                      bx[None, :, None, :]][None]
    a = torch.softmax(logits.reshape(B, heads, H, W, k * k), -1)
    out = torch.einsum("bnyxij,byixjnf->byxnf", a.reshape(logits.shape),
                       v[:, ny][:, :, :, nx])
    return F_.linear(out.reshape(B, H, W, C), p[f"{pre}.proj.weight"],
                     p[f"{pre}.proj.bias"])


def forward(p, images, embed_dim, depths, num_heads, kernel_size,
            dilations, **_):
    """[B,in_chans,H,W] -> logits [B,num_classes], DiNAT's keywords."""
    def norm(x, name):
        return F_.layer_norm(x, x.shape[-1:], p[f"{name}.weight"],
                             p[f"{name}.bias"])

    def linear(x, name):
        return F_.linear(x, p[f"{name}.weight"], p[f"{name}.bias"])

    def conv(x, name):
        return F_.conv2d(x, p[f"{name}.weight"], p.get(f"{name}.bias"), 2, 1)

    x = conv(conv(images, "patch_embed.proj.0"), "patch_embed.proj.1")
    x = norm(x.permute(0, 2, 3, 1), "patch_embed.norm")
    for i, depth in enumerate(depths):
        for j in range(depth):
            s = f"levels.{i}.blocks.{j}"
            x = x + attention(p, norm(x, f"{s}.norm1"), f"{s}.attn",
                              num_heads[i], kernel_size, dilations[i][j])
            x = x + linear(F_.gelu(linear(norm(x, f"{s}.norm2"),
                                          f"{s}.mlp.fc1")), f"{s}.mlp.fc2")
        if i < len(depths) - 1:
            s = f"levels.{i}.downsample"
            x = conv(x.permute(0, 3, 1, 2), f"{s}.reduction")
            x = norm(x.permute(0, 2, 3, 1), f"{s}.norm")
    return linear(norm(x, "norm").flatten(1, 2).mean(1), "head")
