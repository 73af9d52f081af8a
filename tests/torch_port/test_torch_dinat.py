"""DiNAT (stnls_tpu_torch/models/dinat.py) against its plain reference
(stnls_tpu_torch/testing/dinat_reference.py) on the CPU, where the search
(B5, B6) and the pooled sum (B9, B10) run their plain versions: one
NeighborhoodAttention at several (map, k, d), and the whole model at a
small size with the published structure.

Tolerances: the port sums the logits in the search's order (a channel at
a time) and the values in the pool's (a slot at a time), the reference by
einsum, so they agree to float32 rounding, not bitwise. Each tolerance is
about 10x above the port's readings here and below what TF32 operands
give (bench_h100's control reads 7e-4 in the logits and 1e-3 in the
gradients at the bench's small size).
"""

import ast
from pathlib import Path

import pytest
import torch

from stnls_tpu_torch.models.dinat import NeighborhoodAttention, bias_index
from stnls_tpu_torch.testing import dinat_reference

from torch_port_helpers import DINAT_SMALL, dinat_case, dinat_errors, \
    dinat_reference_step, dinat_train_step

CPU = torch.device("cpu")
# one layer: largest |out - reference's| (|out| ~ 0.6; read <= 6e-8 over
# the cases) and the worst gradient's error norm over its norm (read <=
# 2.3e-7)
NA_TOLS = dict(out=1e-6, grad=3e-6)
# the model: logits (|logit| ~ 1.4; read 0), the loss relative (read 0),
# the worst parameter's gradient relative (read 4.8e-7 to 1.2e-6 on 4
# seeds)
MODEL_TOLS = dict(out=1e-6, loss=1e-6, grad=1e-5)

# (H, W, C, heads, k, d)
NA_CASES = {
    "na_k3": (12, 12, 8, 2, 3, 1),
    "na_k7_odd_map": (9, 13, 16, 2, 7, 1),
    "dina_map_is_dk": (12, 12, 8, 2, 3, 4),      # every window its class
    "dina_map_not_multiple_of_d": (13, 11, 8, 2, 3, 3),
    "dina_d2_rows_cols_differ": (10, 15, 16, 2, 3, 2),
    "dina_k7_d2_map_is_dk": (14, 14, 8, 1, 7, 2),
    "dina_k5_d2": (17, 12, 8, 4, 5, 2),
}


def _layer(C, heads, k, d, seed=0):
    na = NeighborhoodAttention(C, heads, k, d)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in na.named_parameters():
            bound = 0.5 if name == "rpb" else \
                p[0].numel() ** -0.5 if p.ndim > 1 else 0.1
            p.copy_((torch.rand(p.shape, generator=gen) * 2 - 1) * bound)
    return na, dict(na.named_parameters())


@pytest.mark.parametrize("case", list(NA_CASES))
def test_neighborhood_attention_matches_the_reference(case):
    """Output and the gradients of the input and every parameter; the
    bias table drawn within 0.5, so that a wrong index at a border or in
    a residue class shows."""
    H, W, C, heads, k, d = NA_CASES[case]
    na, params = _layer(C, heads, k, d)
    x = torch.randn((2, H, W, C), generator=torch.Generator().manual_seed(1),
                    requires_grad=True)
    out = na(x)
    ref = dinat_reference.attention({f"a.{n}": p for n, p in params.items()},
                                     x, "a", heads, k, d)
    assert float((out - ref).detach().abs().max()) <= NA_TOLS["out"]
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(2))
    leaves = [x] + list(params.values())
    for a, b in zip(torch.autograd.grad(out, leaves, g),
                    torch.autograd.grad(ref, leaves, g)):
        assert float((a - b).norm() / b.norm()) <= NA_TOLS["grad"]


@pytest.mark.parametrize("case", list(NA_CASES))
def test_bias_index_is_the_reference_s_at_every_border(case):
    """The model's bias index (from the search's window offsets) equals
    the reference's (NATTEN's rule) for every query, border rows and
    columns included, and reaches both ends of the table on each axis."""
    H, W, _, _, k, d = NA_CASES[case]
    _, by = dinat_reference.neighborhood(H, k, d)
    _, bx = dinat_reference.neighborhood(W, k, d)
    want = by[:, None, :, None] * (2 * k - 1) + bx[None, :, None, :]
    idx = bias_index(H, W, k, d, CPU).reshape(H, W, k, k)
    assert torch.equal(idx, want)
    assert int(by.min()) == 0 and int(by.max()) == 2 * k - 2
    assert int(bx.min()) == 0 and int(bx.max()) == 2 * k - 2


def test_the_neighbourhood_stays_in_the_query_s_residue_class():
    nbr, _ = dinat_reference.neighborhood(13, 3, 3)
    i = torch.arange(13)[:, None]
    assert bool(((nbr - i) % 3 == 0).all())
    assert bool(((nbr >= 0) & (nbr < 13)).all())
    # the last query of class 0 (12) takes its class's last three members
    assert nbr[12].tolist() == [6, 9, 12]


@pytest.mark.parametrize("seed", [0, 1])
def test_dinat_matches_the_reference(seed):
    """The logits, the mean cross-entropy and every parameter's gradient
    of the whole small model."""
    net, params, images, labels = dinat_case(seed)
    run = dinat_train_step(net, images, labels, CPU)
    ref = dinat_reference_step(params, images, labels)
    assert set(run["grads"]) == set(ref["grads"])
    out, loss, grad = dinat_errors(run, ref)
    assert out <= MODEL_TOLS["out"] and loss <= MODEL_TOLS["loss"] and \
        grad <= MODEL_TOLS["grad"], (out, loss, grad)


def test_calls_count_one_a_layer_and_a_small_map_raises():
    net, _, images, _ = dinat_case(3, B=1)
    before = NeighborhoodAttention.calls
    net(images)
    assert NeighborhoodAttention.calls - before == sum(DINAT_SMALL["depths"])
    with pytest.raises(ValueError, match="smaller than the dilated window"):
        net(images[..., :80, :80])       # level 1's map 20 < 3 x 8


def test_the_published_widths_give_dinat_tiny():
    from stnls_tpu_torch.models import DiNAT
    net = DiNAT()
    assert sum(p.numel() for p in net.parameters()) == 27_901_582
    layers = [blk.attn for lvl in net.levels for blk in lvl.blocks]
    assert [a.dilation for a in layers] == \
        [1, 8, 1] + [1, 4, 1, 4] + [1, 2] * 9 + [1] * 5
    assert {(a.kernel, a.head_dim) for a in layers} == {(7, 32)}


def test_the_reference_imports_nothing_of_the_port_or_of_jax():
    tree = ast.parse(Path(dinat_reference.__file__).read_text())
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names} | {n.module for n in ast.walk(tree)
                                  if isinstance(n, ast.ImportFrom)}
    assert names == {"torch", "torch.nn.functional"}
