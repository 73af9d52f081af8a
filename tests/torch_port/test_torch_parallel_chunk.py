"""Port parity of the search's temporal-chunk mode (time sharding), on
the CPU, where every kernel runs its plain version:

  * the plain chunk volume (B5's chunk mode, ops/nls.nls_search_volume_chunk)
    and its offsets (ops/nls_k.search_aux) against the JAX package's
    nls_search_volume_chunk, at t0 in {0, T_local}, ps 1 and 3, float and
    int;
  * the lazy route's plain chunk (B1's selection and B2's backward through
    search.non_local_search.nls_pipeline) against JAX's lattice chunk,
    anchor_self and top-K, as JAX's time-sharded rank body runs them:
    dists, offsets and the gradients into both padded videos;
  * chunk against whole: both routes' chunks, joined over the sequence,
    equal the search of the whole video exactly.
All at atol = rtol = 1e-4 against JAX (gradients at 1e-4 * max|g|). The
halo frames beyond the sequence ends hold noise: a window that read them
would show."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from stnls_tpu.ops.nls import nls_search_volume_chunk as jax_chunk, \
    dist_type_select
from stnls_tpu.ops import anchor as anchor_ops
from stnls_tpu.ops import topk as topk_ops

from stnls_tpu_torch.ops.nls import nls_search_volume_chunk, chunk_frames
from stnls_tpu_torch.ops.nls_k import search_aux, aux_to_inds3
from stnls_tpu_torch.search.non_local_search import nls_pipeline, \
    extract_config, search_route

from torch_port_helpers import to_torch, assert_close, assert_grad_close

B, HD, T, F, H, W = 1, 2, 8, 3, 10, 10
T_LOCAL, WT = 4, 1
HALO = 2 * WT


def _inputs(rng, t0):
    """A whole sequence, and the chunk of T_LOCAL frames from t0 with its
    halos (noise where they fall beyond the sequence)."""
    vid = rng.standard_normal((2, B, HD, T, F, H, W)).astype(np.float32)
    flows = (1.5 * rng.standard_normal((B, HD, T, 2 * WT, 2, H, W))) \
        .astype(np.float32)
    noise = rng.standard_normal((2, B, HD, T + 2 * HALO, F, H, W)) \
        .astype(np.float32)
    noise[:, :, :, HALO:HALO + T] = vid
    pad = noise[:, :, :, t0:t0 + T_LOCAL + 2 * HALO]
    return vid, flows, pad, flows[:, :, t0:t0 + T_LOCAL]


@pytest.mark.parametrize("t0", [0, T_LOCAL])
@pytest.mark.parametrize("ps,itype", [(1, "float"), (3, "float"),
                                      (1, "int"), (3, "int")])
def test_chunk_volume_matches_jax(rng, t0, ps, itype):
    _, _, (v0p, v1p), fl = _inputs(rng, t0)
    kw = dict(ws=3, wt=WT, ps=ps, stride0=1,
              stride1=0.5 if itype == "float" else 1, itype=itype)
    jd, ji = jax_chunk(jnp.asarray(v0p), jnp.asarray(v1p), jnp.asarray(fl),
                       t0=t0, T_global=T, halo=HALO, **kw)
    td = nls_search_volume_chunk(to_torch(v0p), to_torch(v1p), to_torch(fl),
                                 t0=t0, T_global=T, halo=HALO, **kw)
    aux = search_aux(v0p.shape, to_torch(fl), ws=3, wt=WT, stride0=1,
                     stride1=kw["stride1"], itype=itype, query_t0=t0,
                     T_global=T)
    assert td.shape == jd.shape == (B, HD, T_LOCAL, 3, 3, 3, H, W)
    assert_close(td, jd, "dists")
    assert_close(aux_to_inds3(aux, td.shape), ji, "offsets")


def _jax_rank_body(v0p, v1p, fl, t0, kw, K):
    """JAX's lattice chunk, anchor_self and top-K (parallel/shard.py's
    chunk_fn), and the gradients of sum(d * gd) into both videos."""

    def body(a, b, gd):
        dists, inds3 = jax_chunk(a, b, fl, t0=t0, T_global=T, halo=HALO,
                                 **kw)
        Bl, HDl, Tl, G, ws, _, nH, nW = dists.shape
        Q = Tl * nH * nW
        d = jnp.transpose(dists, (0, 1, 2, 6, 7, 3, 4, 5)) \
            .reshape(Bl, HDl, Q, -1)
        i3 = jnp.transpose(inds3, (0, 1, 2, 3, 7, 8, 4, 5, 6)) \
            .reshape(3, Bl, HDl, Q, -1)
        d, i3, _ = anchor_ops.anchor_self(d, i3)
        d, i3 = topk_ops.topk(d, i3, K, dist_type_select("l2")[1],
                              anchor=True)
        d = d.reshape(Bl, HDl, Tl, nH, nW, -1)
        inds = jnp.moveaxis(i3.reshape(3, Bl, HDl, Tl, nH, nW, -1), 0, -1)
        return jnp.sum(d * gd), (d, inds)

    return body


@pytest.mark.parametrize("t0", [0, T_LOCAL])
@pytest.mark.parametrize("ps,itype", [(3, "float"), (1, "int")])
def test_lazy_route_chunk_matches_jax(rng, t0, ps, itype):
    """B1's selection and B2's backward (plain versions) in chunk mode."""
    _, _, (v0p, v1p), fl = _inputs(rng, t0)
    K = 5
    kw = dict(ws=3, wt=WT, ps=ps, stride0=1,
              stride1=0.5 if itype == "float" else 1, itype=itype)
    cfg = extract_config(dict(kw, k=K, self_action="anchor"))
    assert search_route(cfg, v0p.shape, T) == "topk"
    tv0, tv1 = to_torch(v0p, True), to_torch(v1p, True)
    td, ti = nls_pipeline(tv0, tv1, to_torch(fl), cfg, query_t0=t0,
                          T_global=T)
    gd = rng.standard_normal(tuple(td.shape)).astype(np.float32)
    (_, (jd, ji)), jg = jax.value_and_grad(
        _jax_rank_body(v0p, v1p, jnp.asarray(fl), t0, kw, K),
        argnums=(0, 1), has_aux=True)(jnp.asarray(v0p), jnp.asarray(v1p),
                                      jnp.asarray(gd))
    tg = torch.autograd.grad((td * torch.from_numpy(gd)).sum(), (tv0, tv1))
    assert_close(td, jd, "dists")
    assert_close(ti, ji, "inds")
    for a, b, name in zip(tg, jg, ("g_vid0", "g_vid1")):
        assert_grad_close(a, b, name)


@pytest.mark.parametrize("route,k", [("topk", 5), ("volume", 70)])
def test_chunks_joined_equal_the_whole_search(rng, route, k):
    """Both routes' chunks, joined over the sequence, equal the whole
    video's search exactly (dists, offsets)."""
    cfg = extract_config(dict(ws=5 if route == "volume" else 3, wt=WT, ps=3,
                              k=k, stride1=0.5, self_action="anchor"))
    assert search_route(cfg, (B, HD, T_LOCAL + 2 * HALO, F, H, W), T) \
        == route
    vid, flows, _, _ = _inputs(rng, 0)
    d_all, i_all = nls_pipeline(to_torch(vid[0]), to_torch(vid[1]),
                                to_torch(flows), cfg)
    for t0 in range(0, T, T_LOCAL):
        _, _, (v0p, v1p), fl = _inputs(np.random.default_rng(t0), t0)
        lo, hi = max(0, t0 - HALO), min(T, t0 + T_LOCAL + HALO)
        v0p[:, :, lo - t0 + HALO:hi - t0 + HALO] = vid[0][:, :, lo:hi]
        v1p[:, :, lo - t0 + HALO:hi - t0 + HALO] = vid[1][:, :, lo:hi]
        d, i = nls_pipeline(to_torch(v0p), to_torch(v1p),
                            to_torch(flows[:, :, t0:t0 + T_LOCAL]), cfg,
                            query_t0=t0, T_global=T)
        assert torch.equal(d, d_all[:, :, t0:t0 + T_LOCAL])
        assert torch.equal(i, i_all[:, :, t0:t0 + T_LOCAL])


def test_chunk_frames_checks_the_halo():
    assert chunk_frames(5, 5, 2) == (0, 5, 0)
    assert chunk_frames(4, 8, 1, 4, 12) == (4, 12, 2)
    for args in ((4, 8, 1), (4, 8, 1, 4), (4, 8, 2, 0, 8), (4, 9, 1, 0, 8),
                 (4, 8, 1, 10, 12), (4, 8, 1, -1, 12)):
        with pytest.raises(ValueError):
            chunk_frames(*args)
