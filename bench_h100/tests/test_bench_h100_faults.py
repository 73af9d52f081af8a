"""A whole run on the CPU (the look for a chip skipped) with the timed
path broken underneath comes out not correct: an answer altered where it
is produced, and, for the train cells, half of the batch left out of the
loss. The cells have no state a step would leave unchanged and no
exchange between chips."""

import pytest
import torch

from _small import CELLS, run_small
from stnls_tpu_torch import matrix_steps
from stnls_tpu_torch.search.non_local_search import NonLocalSearch
from stnls_tpu_torch.utils.config import ConfigDict


def test_a_sound_run_is_correct():
    res = run_small("align1080p.infer")
    assert res["correct"] and res["failed"] == 0
    assert list(res)[-1] == "compared"


def _altered(make):
    def wrapped(*args, **kw):
        step = make(*args, **kw)

        def broken(*x):
            out = dict(step(*x))
            key = "out" if "out" in out else "dists"
            out[key] = out[key].clone()
            out[key].view(-1)[7] += 0.05
            return out
        return broken
    return wrapped


def _altered_model(make):
    def wrapped(*args, **kw):
        model = make(*args, **kw)
        forward = model.forward

        def broken(*x, **k):
            out, state = forward(*x, **k)
            out = out.clone()
            out.view(-1)[7] += 0.05
            return out, state
        model.forward = broken
        return model
    return wrapped


@pytest.mark.parametrize("cell", CELLS)
def test_an_altered_answer_is_caught(cell, monkeypatch):
    monkeypatch.setattr(matrix_steps, "make_step",
                        _altered(matrix_steps.make_step))
    monkeypatch.setattr(matrix_steps, "denoiser",
                        _altered_model(matrix_steps.denoiser))
    assert run_small(cell)["correct"] is False


def _half_batch(name, params=None, seed=0, **size):
    """The step with the loss taken over the first half of the frames."""
    cfg = matrix_steps.config(name, **size)
    keep = (cfg["T"] + 1) // 2
    if cfg["config"] == 6:
        model = matrix_steps.denoiser(name, **size)
        model.load_state_dict(params)

        def step(noisy, clean, fflow, bflow):
            out, _ = model(noisy, ConfigDict(fflow=fflow, bflow=bflow))
            loss = (out[:, :keep] - clean[:, :keep]).pow(2).mean()
            names, ps = zip(*model.named_parameters())
            grads = torch.autograd.grad(loss, ps)
            return dict(out=out.detach(), loss=loss.detach(),
                        grads=dict(zip(names, grads)))
        return step
    search = NonLocalSearch(cfg["ws"], cfg["wt"], cfg["ps"], cfg["K"],
                            nheads=cfg["HD"], self_action="anchor",
                            itype=cfg["itype"])

    def step(vid, fflow, bflow):
        v = vid.detach().requires_grad_()
        dists, inds = search(v, v, fflow, bflow)
        loss = dists[:, :, :keep].pow(2).mean()
        g_vid, = torch.autograd.grad(loss, v)
        return dict(dists=dists.detach(), inds=inds.detach(),
                    loss=loss.detach(), g_vid=g_vid)
    return step


@pytest.mark.parametrize("cell", [c for c in CELLS if c.endswith("train")])
def test_half_the_batch_left_out_is_caught(cell, monkeypatch):
    monkeypatch.setattr(matrix_steps, "make_step", _half_batch)
    assert run_small(cell)["correct"] is False
