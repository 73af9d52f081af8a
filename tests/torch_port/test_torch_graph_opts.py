"""The port's graph_opts (scatter_labels, scatter_tensor, gather_tensor)
and NonLocalScatter against the JAX package on the same numpy inputs: the
four cases of tests/agg/test_scatter.py on the port; labels, names,
scattered and gathered tensors and run_topk against JAX's (integers
exactly, floats at 1e-5), both fed JAX's own int search outputs so that
a near-tie of the two searches cannot move the comparison;
NonLocalScatter's stack, mask and gradients into the video and the
weights against jax.grad (stack and mask at 1e-5, gradients at 1e-4 *
max|ref|) over ps, stride0 and reflect_bounds; the dropped writes of a
small S; the stride1 < 1 refusal; the whole path (int search, labels,
scatter, loss, gradient) against JAX's lattice search; and the agg menu's
"scatter"."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import stnls_tpu
import stnls_tpu_torch
from stnls_tpu.graph_opts import scatter_labels as j_labels, \
    scatter_tensor as j_scatter, gather_tensor as j_gather
from stnls_tpu_torch.graph_opts import scatter_labels, scatter_tensor, \
    gather_tensor
from stnls_tpu_torch.agg import NonLocalScatter

from torch_port_helpers import to_torch, to_np, assert_grad_close

FTOL = 1e-5
B, HD, T, F, H, W = 1, 2, 3, 3, 8, 8
WS, WT, K = 3, 1, 6


def assert_float(port, ref, what=""):
    np.testing.assert_allclose(to_np(port), to_np(ref), atol=FTOL,
                               rtol=FTOL, err_msg=what)


def assert_exact(port, ref, what=""):
    port, ref = to_np(port), to_np(ref)
    assert port.dtype == ref.dtype, what
    np.testing.assert_array_equal(port, ref, err_msg=what)


def _search_outputs(stride0, seed=0):
    """JAX's int search on seeded inputs, as numpy: (vid [B,HD,T,F,H,W],
    flows, dists, inds int32)."""
    rng = np.random.default_rng(seed)
    vid = rng.standard_normal((B, HD, T, F, H, W)).astype(np.float32)
    nH = (H - 1) // stride0 + 1
    flows = np.round(rng.standard_normal((B, HD, T, 2 * WT, 2, nH, nH))) \
        .astype(np.float32)
    search = stnls_tpu.search.NonLocalSearch(WS, WT, 1, K, stride0=stride0,
                                             itype="int", impl="lattice")
    dists, inds = search(jnp.asarray(vid), jnp.asarray(vid),
                         jnp.asarray(flows))
    return vid, flows, np.array(dists), np.array(inds)


@pytest.fixture(scope="module")
def searched():
    return {s0: _search_outputs(s0) for s0 in (1, 2)}


def _labels(out, stride0=1):
    vid, flows, dists, inds = out
    return scatter_labels.run(to_torch(flows), torch.from_numpy(inds), WS,
                              WT, stride0, 1, H, W, True)


# -- the four cases of tests/agg/test_scatter.py, on the port --

def test_scatter_labels_collision_free(searched):
    vid, flows, dists, inds = searched[1]
    _, labels = _labels(searched[1])
    lab = labels.numpy()
    assert (lab >= 0).all()
    q1, _ = scatter_labels._dest_raster(torch.from_numpy(inds), 1, 1, T, H,
                                        W)
    pairs = np.stack([q1.numpy().reshape(B, HD, -1),
                      lab.reshape(B, HD, -1)], -1)
    for b in range(B):
        for h in range(HD):
            assert len(np.unique(pairs[b, h], axis=0)) == pairs.shape[2], \
                "label collision at a destination"


def test_scatter_gather_tensor_roundtrip(searched):
    vid, flows, dists, inds = searched[1]
    _, labels = _labels(searched[1])
    weights = torch.from_numpy(dists)
    scat = scatter_tensor.run(weights, torch.from_numpy(inds), labels, 1, 1,
                              H, W)
    # every original weight appears exactly once among the finite slots
    finite = scat[scat.isfinite()].numpy()
    np.testing.assert_allclose(np.sort(finite), np.sort(dists.ravel()),
                               rtol=1e-5, atol=1e-6)
    Q = T * H * W
    qs = torch.arange(Q, dtype=torch.float32)[None, None, :, None] \
        .expand(B, HD, Q, K).reshape(B, HD, T, H, W, K)
    gat = gather_tensor.run(qs, torch.from_numpy(inds), labels, 1, 1, H, W)
    assert gat.shape[2] == Q


def test_nonlocal_scatter_conserves_mass(searched):
    vid, flows, dists, inds = searched[1]
    _, labels = _labels(searched[1])
    weights = torch.ones(B, HD, T, H, W, K)
    stack, mask = NonLocalScatter(ps=1, stride0=1)(
        to_torch(vid), weights, torch.from_numpy(inds), labels)
    np.testing.assert_allclose(float(stack.sum()), float(vid.sum()) * K,
                               rtol=1e-4)
    assert float(mask.sum()) == B * HD * T * H * W * K


def test_graph_opts_with_static_S(searched):
    vid, flows, dists, inds = searched[1]
    _, labels = _labels(searched[1])
    S = scatter_labels.slot_bound(WS, WT, 1, T, True)
    assert int(labels.max()) < S
    weights, inds_t = torch.from_numpy(dists), torch.from_numpy(inds)
    ref = scatter_tensor.run(weights, inds_t, labels, 1, 1, H, W)
    out = scatter_tensor.run(weights, inds_t, labels, 1, 1, H, W, S=S)
    assert out.shape[-1] == S
    assert torch.equal(out[..., :ref.shape[-1]], ref)
    assert out[..., ref.shape[-1]:].isinf().all()
    gat = gather_tensor.run(weights, inds_t, labels, 1, 1, H, W, S=S)
    assert gat.shape[2:] == (T * H * W, S)
    stack, mask = NonLocalScatter(ps=1, stride0=1, S=S)(
        to_torch(vid), torch.ones(B, HD, T, H, W, K), inds_t, labels)
    assert stack.shape[2] == S


# -- against the JAX package --

@pytest.mark.parametrize("stride0", [1, 2])
def test_labels_and_names_match_jax(searched, stride0):
    vid, flows, dists, inds = searched[stride0]
    names, labels = _labels(searched[stride0], stride0)
    j_names, j_lab = j_labels.run(jnp.asarray(flows), jnp.asarray(inds), WS,
                                  WT, stride0, 1, H, W, True)
    assert_exact(labels, j_lab, "labels")
    assert_exact(names, j_names, "names")
    # float offsets (rounded) give the same labels
    _, lab_f = scatter_labels.run(to_torch(flows),
                                  torch.from_numpy(inds).float() + 0.2, WS,
                                  WT, stride0, 1, H, W, True)
    assert torch.equal(lab_f, labels)


# (tensor, invalid) fed to scatter_tensor and gather_tensor: the search's
# dists (float), its offsets (int32, M = 3) and the labels (int32)
TENSORS = [("dists", np.inf), ("inds", -1), ("labels", -7)]


def _tensor(which, dists, inds, labels):
    return {"dists": dists, "inds": inds, "labels": labels}[which]


@pytest.mark.parametrize("op", ["scatter", "gather"])
@pytest.mark.parametrize("which,invalid", TENSORS)
@pytest.mark.parametrize("S", [None, "bound"])
def test_scatter_and_gather_tensor_match_jax(searched, op, which, invalid,
                                             S):
    """S = labels.max()+1 or slot_bound: every slot unique, no clipped
    duplicates."""
    vid, flows, dists, inds = searched[1]
    j_names, j_lab = j_labels.run(jnp.asarray(flows), jnp.asarray(inds), WS,
                                  WT, 1, 1, H, W, True)
    lab = np.array(j_lab).reshape(B, HD, T, H, W, K)
    S = scatter_labels.slot_bound(WS, WT, 1, T, True) if S else None
    x = _tensor(which, dists, inds, lab)
    port = {"scatter": scatter_tensor, "gather": gather_tensor}[op].run(
        torch.from_numpy(x), torch.from_numpy(inds), torch.from_numpy(lab),
        1, 1, H, W, invalid=invalid, S=S)
    ref = {"scatter": j_scatter, "gather": j_gather}[op].run(
        jnp.asarray(x), jnp.asarray(inds), jnp.asarray(lab), 1, 1, H, W,
        invalid=invalid, S=S)
    if which == "dists":
        assert_float(port, ref, f"{op} {which}")
    else:
        assert_exact(port, ref, f"{op} {which}")


def test_scatter_tensor_inf_into_ints_matches_jax(searched):
    """invalid=inf into an int32 tensor: XLA saturates the conversion."""
    vid, flows, dists, inds = searched[1]
    _, lab = _labels(searched[1])
    lab = lab.reshape(B, HD, T, H, W, K)
    port = scatter_tensor.run(lab, torch.from_numpy(inds), lab, 1, 1, H, W)
    ref = j_scatter.run(jnp.asarray(lab.numpy()), jnp.asarray(inds),
                        jnp.asarray(lab.numpy()), 1, 1, H, W)
    assert_exact(port, ref, "labels scattered with invalid=inf")


@pytest.mark.parametrize("topk,descending", [(4, True), (0, True),
                                             (3, False)])
def test_run_topk_matches_jax(searched, topk, descending):
    """On the scattered weights, offsets and labels (the empty slots'
    inf weights tie: a stable sort keeps their slot order)."""
    vid, flows, dists, inds = searched[1]
    _, lab = j_labels.run(jnp.asarray(flows), jnp.asarray(inds), WS, WT, 1,
                          1, H, W, True)
    lab = np.array(lab).reshape(B, HD, T, H, W, K)
    args = [(dists, np.inf), (inds, 0), (lab, -1)]
    j_in = [j_scatter.run(jnp.asarray(x), jnp.asarray(inds),
                          jnp.asarray(lab), 1, 1, H, W, invalid=inv)
            for x, inv in args]
    t_in = [torch.from_numpy(np.array(x)) for x in j_in]
    ref = j_scatter.run_topk(*j_in, topk, descending)
    port = scatter_tensor.run_topk(*t_in, topk, descending)
    for p, r, what in zip(port, ref, ("weights", "flows", "labels")):
        assert_exact(p, r, f"run_topk {what}")


def _jax_scatter(vid, w, inds, lab, S=None, **kw):
    return stnls_tpu.agg.NonLocalScatter(S=S, **kw)(vid, w, inds, lab)


@pytest.mark.parametrize("ps", [1, 3])
@pytest.mark.parametrize("stride0", [1, 2])
@pytest.mark.parametrize("reflect", [True, False])
def test_nonlocal_scatter_matches_jax(searched, ps, stride0, reflect):
    vid, flows, dists, inds = searched[stride0]
    _, lab = j_labels.run(jnp.asarray(flows), jnp.asarray(inds), WS, WT,
                          stride0, 1, H, W, True)
    lab = np.array(lab)
    w = np.array(jax.nn.softmax(-dists, -1))
    kw = dict(ps=ps, stride0=stride0, reflect_bounds=reflect)
    j_stack, j_mask = _jax_scatter(jnp.asarray(vid), jnp.asarray(w),
                                   jnp.asarray(inds), jnp.asarray(lab), **kw)
    cot = np.random.default_rng(1).standard_normal(j_stack.shape) \
        .astype(np.float32)
    j_g = jax.grad(lambda v, ww: jnp.sum(_jax_scatter(
        v, ww, jnp.asarray(inds), jnp.asarray(lab), **kw)[0] * cot),
        (0, 1))(jnp.asarray(vid), jnp.asarray(w))
    tv, tw = to_torch(vid, True), to_torch(w, True)
    stack, mask = NonLocalScatter(**kw)(tv, tw, torch.from_numpy(inds),
                                        torch.from_numpy(lab))
    assert_float(stack, j_stack, "stack")
    assert_float(mask, j_mask, "mask")
    g = torch.autograd.grad((stack * torch.from_numpy(cot)).sum(), (tv, tw))
    for gp, gr, what in zip(g, j_g, ("g_vid", "g_weights")):
        assert float(np.abs(to_np(gr)).max()) > 0, what
        assert_grad_close(gp, gr, what)


def test_small_S_drops_like_jax(searched):
    """A hand-passed S below labels.max()+1: NonLocalScatter drops the
    edges whose label is >= S (the writes JAX drops past its buffer);
    scatter_tensor clips them into slot S-1, where several edges then
    collide and the last in edge order is kept, as JAX keeps it on the
    CPU."""
    vid, flows, dists, inds = searched[1]
    _, lab = j_labels.run(jnp.asarray(flows), jnp.asarray(inds), WS, WT, 1,
                          1, H, W, True)
    lab = np.array(lab)
    S = 2
    assert lab.max() + 1 > S
    w = np.array(jax.nn.softmax(-dists, -1))
    j_stack, j_mask = _jax_scatter(jnp.asarray(vid), jnp.asarray(w),
                                   jnp.asarray(inds), jnp.asarray(lab), S=S,
                                   ps=3, stride0=1)
    stack, mask = NonLocalScatter(ps=3, stride0=1, S=S)(
        to_torch(vid), to_torch(w), torch.from_numpy(inds),
        torch.from_numpy(lab))
    assert stack.shape[2] == S
    assert_float(stack, j_stack, "stack at S=2")
    assert_float(mask, j_mask, "mask at S=2")
    port = scatter_tensor.run(torch.from_numpy(dists),
                              torch.from_numpy(inds), torch.from_numpy(lab),
                              1, 1, H, W, S=S)
    ref = j_scatter.run(jnp.asarray(dists), jnp.asarray(inds),
                        jnp.asarray(lab), 1, 1, H, W, S=S)
    assert_float(port, ref, "scatter_tensor with clipped labels")


def test_out_of_range_frames_and_labels_match_jax():
    """Offsets of round(3 * normal) frames at T = 3 leave [0, T) after one
    reflection, and labels from -S-1 to S+1 leave [0, S): each write whose
    flat index falls outside its (b, hd) row wraps back from the row's end
    or is dropped, as JAX's .at[] does, and none reaches another head's
    row. Stack and mask at 1e-5, the gradients at 1e-4 * max|ref|."""
    rng = np.random.default_rng(5)
    S = 3
    vid = rng.standard_normal((B, HD, T, F, H, W)).astype(np.float32)
    w = rng.random((B, HD, T * H * W, K)).astype(np.float32)
    inds = np.stack([np.round(3 * rng.standard_normal((B, HD, T, H, W, K))),
                     *np.round(2 * rng.standard_normal((2, B, HD, T, H, W,
                                                        K)))], -1) \
        .astype(np.int32)
    lab = rng.integers(-S - 1, S + 2, (B, HD, T * H * W, K)).astype(np.int32)
    nt = np.arange(T)[:, None, None, None] + inds[..., 0]
    nt = np.where(nt < 0, -nt, np.where(nt >= T, 2 * (T - 1) - nt, nt))
    assert ((nt < 0) | (nt >= T)).any()
    kw = dict(ps=3, stride0=1, S=S)
    j_stack, j_mask = _jax_scatter(jnp.asarray(vid), jnp.asarray(w),
                                   jnp.asarray(inds), jnp.asarray(lab), **kw)
    cot = rng.standard_normal(j_stack.shape).astype(np.float32)
    j_g = jax.grad(lambda v, ww: jnp.sum(_jax_scatter(
        v, ww, jnp.asarray(inds), jnp.asarray(lab), **kw)[0] * cot),
        (0, 1))(jnp.asarray(vid), jnp.asarray(w))
    tv, tw = to_torch(vid, True), to_torch(w, True)
    stack, mask = NonLocalScatter(**kw)(tv, tw, torch.from_numpy(inds),
                                        torch.from_numpy(lab))
    assert_float(stack, j_stack, "stack")
    assert_float(mask, j_mask, "mask")
    g = torch.autograd.grad((stack * torch.from_numpy(cot)).sum(), (tv, tw))
    for gp, gr, what in zip(g, j_g, ("g_vid", "g_weights")):
        assert float(np.abs(to_np(gr)).max()) > 0, what
        assert_grad_close(gp, gr, what)


def test_fractional_stride1_raises():
    """int(0.5) = 0: JAX divides by it without an error; the port refuses."""
    inds = torch.zeros(B, HD, T, H, W, K, 3, dtype=torch.int32)
    lab = torch.zeros(B, HD, T * H * W, K, dtype=torch.int32)
    with pytest.raises(ValueError, match="stride1"):
        scatter_labels.run(None, inds, WS, WT, 1, 0.5, H, W, True)
    for op in (scatter_tensor, gather_tensor):
        with pytest.raises(ValueError, match="stride1"):
            op.run(torch.zeros(B, HD, T, H, W, K), inds, lab, 1, 0.5, H, W)


# The whole path's video scale: 2^-5 keeps the dists near 0.1, so that
# softmax(-10 d) spreads its weight over the slots and the dists get a
# cotangent off the anchor (at scale 1 the weights are one-hot and the
# search's backward gets 0). A power of two scales every dist exactly,
# so the search ranks as it does at scale 1.
PATH_SCALE = 2. ** -5


def test_whole_path_matches_jax():
    """An int search (JAX's lattice), the labels, NonLocalScatter with
    softmax(-10 d) weights, and the gradient of mean(stack.sum(2)^2)
    into the video (through the search's dists and the scatter); the
    dists' cotangent is non-zero at most (query, slot) pairs, so the
    search's backward is held to JAX's."""
    rng = np.random.default_rng(3)
    # the shapes of `searched`, whose JAX ops are compiled already
    T_, HD_, F_, n, ws, wt, k = T, HD, F, H, WS, WT, K
    vid = (PATH_SCALE * rng.standard_normal((1, T_, HD_ * F_, n, n))) \
        .astype(np.float32)
    flows = np.round(2 * rng.standard_normal((1, T_, 2 * wt, 2, n, n))) \
        .astype(np.float32)
    skw = dict(nheads=HD_, stride0=1, self_action="anchor", itype="int")

    def jloss(v):
        d, i = stnls_tpu.search.NonLocalSearch(ws, wt, 3, k, impl="lattice",
                                               **skw)(v, v, jnp.asarray(flows))
        _, lab = j_labels.run(jnp.asarray(flows), i, ws, wt, 1, 1, n, n, True)
        stack, mask = stnls_tpu.agg.NonLocalScatter(ps=3, stride0=1)(
            v, jax.nn.softmax(-10. * d, -1), i, lab)
        return jnp.mean(stack.sum(2) ** 2), (i, lab, stack, mask)

    (_, (j_i, j_lab, j_stack, j_mask)), j_g = jax.value_and_grad(
        jloss, has_aux=True)(jnp.asarray(vid))
    tv = to_torch(vid, True)
    d, i = stnls_tpu_torch.search.NonLocalSearch(ws, wt, 3, k, **skw)(
        tv, tv, to_torch(flows))
    _, lab = scatter_labels.run(to_torch(flows), i, ws, wt, 1, 1, n, n, True)
    stack, mask = NonLocalScatter(ps=3, stride0=1)(
        tv, torch.softmax(-10. * d, -1), i, lab)
    g, g_d = torch.autograd.grad(stack.sum(2).pow(2).mean(), (tv, d))
    assert float((g_d != 0).float().mean()) > 0.5
    assert_exact(i, j_i, "search offsets")
    assert_exact(lab, j_lab, "labels")
    assert_float(stack, j_stack, "stack")
    assert_float(mask, j_mask, "mask")
    assert float(np.abs(np.asarray(j_g)).max()) > 0
    assert_grad_close(g, j_g, "g_vid")


def test_agg_menu_builds_scatter():
    agg = stnls_tpu_torch.agg.init({"agg_name": "scatter", "ps": 5,
                                    "stride0": 2, "reflect_bounds": False})
    assert isinstance(agg, NonLocalScatter)
    assert (agg.ps, agg.stride0, agg.reflect_bounds, agg.itype) == \
        (5, 2, False, "int")
    with pytest.raises(ValueError, match="int search"):
        NonLocalScatter(3, 1, itype="float")
