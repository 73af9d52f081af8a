"""Port parity of the search flavours: RefineSearch (float and int, wr 1
and 3, anchor on and off, kr, topk_mode "each", both routes),
PairedSearch (the lazy route, the volume and the paired anchor),
PairedRefine, N3MatMultSearch (l2 and prod), RandIndsSearch with the
random videos injected (torch.Generator streams are not jax.random's),
the search menu and exports, and the stack attention's refine state
path, against the JAX package on the CPU (its lattice engines: cvr runs
only on a TPU).

Inputs come from numpy seed 0. Outputs and offsets agree within atol =
rtol = 1e-4, the gradients into both videos and the offsets within 1e-4 *
max|ref|; the given offsets stay off integers, so the key positions'
bilinear weights are differentiable where both packages take them.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import stnls_tpu
import stnls_tpu_torch
from stnls_tpu.search import rand_inds as j_rand_inds
from stnls_tpu_torch.search import rand_inds as t_rand_inds
from stnls_tpu_torch.search.refinement import refine_route, select_winners

from torch_port_helpers import to_torch, to_np, assert_close, \
    assert_grad_close

B, HD, T, F, H, W = 1, 2, 3, 2, 12, 12
KS = 4


def _given_offsets(rng, itype="float", fill=False):
    """Refine inputs [B,HD,T,H,W,KS,3]: dt in {-1, 0, 1}, (dh, dw) off
    integers; with `fill` one group of one query holds the -1e8 fill."""
    fk = np.empty((B, HD, T, H, W, KS, 3), np.float32)
    fk[..., 0] = rng.integers(-1, 2, fk.shape[:-1])
    sp = 2.5 * rng.standard_normal(fk.shape[:-1] + (2,))
    fk[..., 1:] = np.round(sp) + 0.25 + 0.5 * rng.random(sp.shape)
    if itype == "int":
        fk[..., 1:] = np.round(fk[..., 1:])
    if fill:
        fk[0, 0, 1, 3, 4, 2, 1:] = -1e8
    return fk


def _loss_grads(jfn, tfn, inputs, rng):
    """Run both packages on the numpy inputs; the loss weighs the finite
    dists and the offsets by seeded cotangents (none on the -1e8 fill).
    Returns ((jd, ji, jgrads), (td, ti, tgrads))."""
    tins = [to_torch(x, True) for x in inputs]
    td, ti = tfn(*tins)
    gd = rng.standard_normal(tuple(td.shape)).astype(np.float32)
    gi = rng.standard_normal(tuple(ti.shape)).astype(np.float32)
    gi = np.where(np.abs(to_np(ti)) < 1e7, gi, 0.).astype(np.float32)

    def jloss(*args):
        d, i = jfn(*args)
        return (jnp.sum(jnp.where(jnp.isfinite(d), d * gd, 0.))
                + jnp.sum(i * gi)), (d, i)

    (_, (jd, ji)), jg = jax.value_and_grad(
        jloss, argnums=tuple(range(len(inputs))), has_aux=True)(
        *map(jnp.asarray, inputs))
    loss = torch.where(td.isfinite(), td * torch.from_numpy(gd), 0.).sum() \
        + (ti * torch.from_numpy(gi)).sum()
    # int offsets are rounded: no gradient reaches them
    tg = torch.autograd.grad(loss, tins, allow_unused=True,
                             materialize_grads=True)
    return (jd, ji, jg), (td, ti, tg)


def _check(ref, port, names):
    (jd, ji, jg), (td, ti, tg) = ref, port
    assert tuple(td.shape) == jd.shape and tuple(ti.shape) == ji.shape
    assert_close(td, jd, "dists")
    assert_close(ti, np.asarray(ji, np.float32), "inds")
    for a, b, name in zip(tg, jg, names):
        assert_grad_close(a, b, name)


REFINE = [
    # itype, wr, self_action, kr, topk_mode, k
    ("float", 3, "anchor", -1, "all", 6),
    ("float", 3, None, 3, "all", 6),
    ("float", 1, "anchor", -1, "all", 3),
    ("float", 1, None, 0.5, "all", -1),
    ("int", 3, "anchor", -1, "all", 6),
    ("int", 3, None, 2, "all", 5),
    ("int", 1, "anchor", 0.75, "all", 3),
    ("float", 3, "anchor", -1, "each", 2),
]


@pytest.mark.parametrize("itype,wr,self_action,kr,topk_mode,k", REFINE)
def test_refine_matches_jax(rng, itype, wr, self_action, kr, topk_mode, k):
    v0 = rng.standard_normal((B, T, HD * F, H, W)).astype(np.float32)
    v1 = rng.standard_normal((B, T, HD * F, H, W)).astype(np.float32)
    fk = _given_offsets(rng, itype, fill=(k == -1))
    kw = dict(ws=7, wt=1, wr=wr, k=k, kr=kr, ps=3, nheads=HD, stride0=1,
              self_action=self_action, topk_mode=topk_mode, itype=itype)
    jsearch = stnls_tpu.search.RefineSearch(**kw)
    tsearch = stnls_tpu_torch.search.RefineSearch(**kw)
    assert refine_route(tsearch.cfg, (B, HD, T, F, H, W),
                        (B, HD, T, F, H, W)) == "sparse"
    ref, port = _loss_grads(jsearch, tsearch, (v0, v1, fk), rng)
    _check(ref, port, ("g_vid0", "g_vid1", "g_flows"))
    if itype == "float":
        assert float(port[2][2].abs().max()) > 0


@pytest.mark.parametrize("knobs", [dict(reflect_bounds=False),
                                   dict(pt=2), dict(off_Hq=1, off_Wq=-1)])
def test_refine_lattice_route_matches_jax(rng, knobs):
    """What B2 does not take runs the whole plain lattice."""
    v0 = rng.standard_normal((B, T, HD * F, H, W)).astype(np.float32)
    fk = _given_offsets(rng)
    kw = dict(ws=7, wt=1, wr=3, k=5, ps=3, nheads=HD, stride0=1,
              self_action="anchor", **knobs)
    tsearch = stnls_tpu_torch.search.RefineSearch(**kw)
    assert refine_route(tsearch.cfg, (B, HD, T, F, H, W),
                        (B, HD, T, F, H, W)) == "lattice"
    ref, port = _loss_grads(stnls_tpu.search.RefineSearch(**kw), tsearch,
                            (v0, v0, fk), rng)
    _check(ref, port, ("g_vid0", "g_vid1", "g_flows"))


def test_refine_selection_bands_equal_one_band(rng):
    """The selection in bands of one query row equals the whole volume's
    bitwise (dists and cells), and the restricted_radius flag is inert."""
    v0 = to_torch(rng.standard_normal((B, HD, T, F, H, W)))
    fk = to_torch(_given_offsets(rng))
    cfg = stnls_tpu_torch.search.RefineSearch(
        7, 1, 3, 6, ps=3, nheads=HD, stride0=1, self_action="anchor").cfg
    whole = select_winners(v0, v0, fk, cfg)
    banded = select_winners(v0, v0, fk, cfg, select_cells=1)
    inert = select_winners(v0, v0, fk, dict(cfg, restricted_radius=True))
    for a, b in ((whole, banded), (whole, inert)):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


PAIRED = [("float", None, 4), ("float", "anchor", 4), ("float", None, -1),
          ("int", None, 4), ("int", "anchor", 3)]


@pytest.mark.parametrize("itype,self_action,k", PAIRED)
def test_paired_search_matches_jax(rng, itype, self_action, k):
    f0 = rng.standard_normal((B, HD * F, H, W)).astype(np.float32)
    f1 = rng.standard_normal((B, HD * F, H, W)).astype(np.float32)
    flow = (2.5 * rng.standard_normal((B, HD, 2, H, W)) + 0.3) \
        .astype(np.float32)
    kw = dict(ws=5, ps=3, k=k, nheads=HD, stride0=1, stride1=1,
              self_action=self_action, itype=itype)
    ref, port = _loss_grads(stnls_tpu.search.PairedSearch(**kw),
                            stnls_tpu_torch.search.PairedSearch(**kw),
                            (f0, f1, flow), rng)
    assert port[1].shape[-1] == 2
    _check(ref, port, ("g_frame0", "g_frame1", "g_flow"))


@pytest.mark.parametrize("itype,wr,self_action", [
    ("float", 3, "anchor"), ("float", 1, None), ("int", 3, None)])
def test_paired_refine_matches_jax(rng, itype, wr, self_action):
    f0 = rng.standard_normal((B, HD * F, H, W)).astype(np.float32)
    f1 = rng.standard_normal((B, HD * F, H, W)).astype(np.float32)
    fk = _given_offsets(rng, itype)[:, :, 0, ..., 1:]   # [B,HD,H,W,KS,2]
    kw = dict(ws=7, wr=wr, k=5, ps=3, nheads=HD, stride0=1,
              self_action=self_action, itype=itype)
    ref, port = _loss_grads(stnls_tpu.search.PairedRefine(**kw),
                            stnls_tpu_torch.search.PairedRefine(**kw),
                            (f0, f1, fk), rng)
    _check(ref, port, ("g_frame0", "g_frame1", "g_flows"))


@pytest.mark.parametrize("dist_type", ["l2", "prod"])
def test_n3mm_matches_jax(rng, dist_type):
    """The indexed product, its top-K and the absolute grid it returns."""
    v0 = rng.standard_normal((B, T, HD * F, H, W)).astype(np.float32)
    v1 = rng.standard_normal((B, T, HD * F, H, W)).astype(np.float32)
    ff = (1.5 * rng.standard_normal((B, T, 2, H, W))).astype(np.float32)
    bf = (1.5 * rng.standard_normal((B, T, 2, H, W))).astype(np.float32)
    kw = dict(ws=3, wt=1, ps=3, k=6, nheads=HD, dist_type=dist_type)
    jd, ji = stnls_tpu.search.N3MatMultSearch(**kw)(
        *map(jnp.asarray, (v0, v1, ff, bf)))
    td, ti = stnls_tpu_torch.search.N3MatMultSearch(**kw)(
        *map(to_torch, (v0, v1, ff, bf)))
    assert ti.dtype == torch.int32 and tuple(ti.shape) == ji.shape
    assert_close(td, jd, "dists")
    np.testing.assert_array_equal(to_np(ti), np.asarray(ji))
    # the menu builds it too, with zero flows
    zd, _ = stnls_tpu_torch.search.init(dict(kw, search_name="n3mm"))(
        to_torch(v0), to_torch(v1))
    assert zd.shape == td.shape


@pytest.mark.parametrize("itype", ["float", "int"])
def test_rand_inds_matches_jax(rng, itype):
    """The noise search then the refine, on the same injected noise."""
    cfg = {"search_name": "rand_inds", "ws": 3, "wt": 1, "ps": 3, "k": 4,
           "stride0": 1, "dist_type": "l2", "itype": itype, "nheads": HD}
    v0, v1, r0, r1 = (rng.standard_normal((B, T, HD * F, H, W))
                      .astype(np.float32) for _ in range(4))
    jsearch = j_rand_inds.init(dict(cfg))
    z = jnp.zeros((B, T, 2, H, W), jnp.float32)
    _, jinds = jsearch.nls(jnp.asarray(r0), jnp.asarray(r1), z, z)
    jd, ji = jsearch.refine(jnp.asarray(v0), jnp.asarray(v1), jinds)
    tsearch = t_rand_inds.init(dict(cfg))
    td, ti = tsearch(to_torch(v0), to_torch(v1),
                     rands=(to_torch(r0), to_torch(r1)))
    assert_close(td, jd, "dists")
    assert_close(ti, np.asarray(ji, np.float32), "inds")
    # the generator's stream: the same seed gives the same search
    a = tsearch(to_torch(v0), to_torch(v1))
    b = tsearch(to_torch(v0), to_torch(v1),
                torch.Generator().manual_seed(tsearch.seed))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_menu_and_exports_match_jax():
    """Every MENU name resolves to the flavour stnls_tpu builds, and the
    search package exports what stnls_tpu.search does."""
    for name in stnls_tpu.search.MENU:
        cfg = {"search_name": name, "ws": 3, "wt": 1, "k": 4}
        assert type(stnls_tpu_torch.search.init(cfg)).__name__ == \
            type(stnls_tpu.search.init(cfg)).__name__
        assert stnls_tpu_torch.search.extract_config(cfg).search_name == name
    public = {n for n in dir(stnls_tpu.search) if not n.startswith("_")}
    assert public <= set(dir(stnls_tpu_torch.search))
    nn_public = {n for n in dir(stnls_tpu.nn) if not n.startswith("_")}
    assert nn_public <= set(dir(stnls_tpu_torch.nn))


def test_search_utils_match_jax(rng):
    from stnls_tpu.search import utils as ju
    from stnls_tpu_torch.search import utils as tu
    inds = rng.standard_normal((1, 2, 3, 4, 4, 10, 3)).astype(np.float32)
    for kr in (-1, None, 4, 0.5):
        assert_close(tu.filter_k(to_torch(inds), kr),
                     ju.filter_k(jnp.asarray(inds), kr), f"filter_k {kr}")
    for ti in range(5):
        assert tu.get_time_window_inds(ti, 2, 5) == \
            ju.get_time_window_inds(ti, 2, 5)
    vid = rng.standard_normal((1, 2, 3, 4, 5, 6)).astype(np.float32)
    assert_close(tu.unshape_vid(to_torch(vid)), ju.unshape_vid(vid), "vid")
    v5 = vid.reshape(1, 6, 4, 5, 6)
    assert tuple(tu.empty_flow(to_torch(v5)).shape) == \
        ju.empty_flow(jnp.asarray(v5)).shape
    fl = rng.standard_normal((1, 3, 2, 5, 6)).astype(np.float32)
    assert_close(tu.ensure_flow_shape(to_torch(fl)),
                 ju.ensure_flow_shape(jnp.asarray(fl)), "flow")
    calls = []
    for name in ("refine", "pf_nls", "nls"):
        tu.search_wrap(name, lambda *a: calls.append(len(a)))(*range(7))
    assert calls == [3, 4, 4]


def test_paired_vids_matches_refine_and_nls(rng):
    """paired_vids over PairedSearch equals NonLocalSearch's full volume
    (topk_mode none), and paired_vids_refine over PairedRefine equals
    RefineSearch, as stnls_tpu's own tests hold them."""
    v0 = rng.standard_normal((B, T, F, H, W)).astype(np.float32)
    v1 = rng.standard_normal((B, T, F, H, W)).astype(np.float32)
    flows = (2 * rng.standard_normal((B, T, 2, 2, H, W)) + 0.3) \
        .astype(np.float32)
    paired = stnls_tpu_torch.search.PairedSearch(3, ps=3, k=-1, stride0=1)
    pd, pi = paired.paired_vids(to_torch(v0), to_torch(v1),
                                to_torch(flows), wt=1)
    nd, ni = stnls_tpu_torch.search.NonLocalSearch(
        3, 1, 3, -1, stride0=1, topk_mode="none")(
        to_torch(v0), to_torch(v1), to_torch(flows))
    assert_close(pd, nd, "paired_vids dists")
    assert_close(pi, ni, "paired_vids inds")

    fk = _given_offsets(rng)[:, :1, ..., :3, :]    # one slot a window frame
    for ti in range(T):
        tgrid = stnls_tpu_torch.search.get_time_window_inds(ti, 1, T)
        fk[:, :, ti, ..., 0] = np.array(tgrid) - ti
    prefine = stnls_tpu_torch.search.PairedRefine(7, 3, -1, ps=3,
                                                  stride0=1)
    rd, ri = prefine.paired_vids(to_torch(v0), to_torch(v1), to_torch(fk),
                                 wt=1)
    gd, gi = stnls_tpu_torch.search.RefineSearch(
        7, 1, 3, -1, ps=3, stride0=1)(to_torch(v0), to_torch(v1),
                                      to_torch(fk))
    assert_close(rd, gd, "paired_vids_refine dists")
    assert_close(ri, gi, "paired_vids_refine inds")


def test_attn_stack_refine_state_path(rng):
    """The stack block with search_name="refine" consumes the previous
    call's top-K offsets as its state, with ref_itype="int", as
    tests/nn/test_attn_modules.py runs it: both stages' outputs and the
    recorded state against the flax modules with the same parameters."""
    from stnls_tpu.nn import NonLocalAttentionStack as JStack
    from stnls_tpu.utils.config import ConfigDict as JConfigDict
    from stnls_tpu_torch.convert import params_from_jax
    from stnls_tpu_torch.nn import NonLocalAttentionStack
    from stnls_tpu_torch.utils.config import ConfigDict
    attn_cfg = {"nheads": 2, "embed_dim": 4, "use_attn_projection": True,
                "use_attn_flow": True}
    search_cfg = {"search_name": "nls", "ws": 5, "wt": 1, "ps": 3, "k": 4,
                  "nheads": 2, "stride0": 1, "self_action": "anchor",
                  "itype": "float", "dist_type": "l2", "impl": "lattice"}
    normz_cfg = {"normz_name": "softmax", "normz_scale": 10,
                 "dist_type": "l2"}
    agg_cfg = {"agg_name": "gather", "ps": 3, "stride0": 1,
               "itype": "float"}
    Hs = 8
    vid = rng.standard_normal((1, 3, 8, Hs, Hs)).astype(np.float32)
    ff, bf = ((2 * rng.standard_normal((1, 3, 2, Hs, Hs))).astype(np.float32)
              for _ in range(2))
    jflows = JConfigDict(fflow=jnp.asarray(ff), bflow=jnp.asarray(bf))
    tflows = ConfigDict(fflow=to_torch(ff), bflow=to_torch(bf))
    jstate, tstate = [jnp.zeros(()), None], [torch.zeros(()), None]
    s2 = dict(search_cfg, search_name="refine", wr=1, kr=-1,
              ref_itype="int")
    for stage, scfg in enumerate((search_cfg, s2)):
        scfg = dict(scfg, use_state_update=True)
        jm = JStack(attn_cfg, scfg, normz_cfg, agg_cfg)
        params = jm.init(jax.random.PRNGKey(stage), jnp.asarray(vid), jflows,
                         state=jstate)
        jout, jstate = jm.apply(params, jnp.asarray(vid), jflows,
                                state=jstate)
        tm = NonLocalAttentionStack(attn_cfg, scfg, normz_cfg, agg_cfg)
        tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray,
                                                        params)))
        with torch.no_grad():
            tout, tstate = tm(to_torch(vid), tflows, state=tstate)
        assert tstate[0] is not None and tstate[0].ndim == 7
        assert_close(tstate[0], np.asarray(jstate[0], np.float32),
                     f"stage {stage} state")
        assert_close(tout, jout, f"stage {stage} output")
    # as in stnls_tpu, the attention config's ref_itype (None unless set)
    # takes precedence over the search config's; set there, it mangles
    assert tm.search.itype == "float"
    tm = NonLocalAttentionStack(dict(attn_cfg, ref_itype="int"), s2,
                                normz_cfg, agg_cfg)
    assert tm.search.itype == "int"
