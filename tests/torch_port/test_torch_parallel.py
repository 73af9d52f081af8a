"""Port parity of stnls_tpu_torch/parallel and of the multichip twin
(stnls_tpu_torch/multichip_step.py) against the JAX package on the CPU.

JAX runs on the virtual CPU devices of tests/conftest.py; the port runs
in processes spawned over gloo (torch_port_helpers.run_ranks), which
import no JAX. One spawn of two ranks (a time axis of 2) serves the whole
module: time_sharded_search against JAX's time_sharded_search(impl=
"lattice") on two devices (dists and offsets at atol = rtol = 1e-4, the
gradients into both videos likewise, as tests/parallel/test_sharding.py
holds JAX's), halo_gather against JAX's, shard_search on a data axis of
2, and the twin's step on a 1 x 2 mesh against the dryrun's step written
with JAX's functions (the loss, the gradients and every updated parameter
at 1e-4 * max|ref|). The 2 x 2 mesh of dryrun_multichip(4) and JAX's
Pallas chunk path (interpret mode) are the slow tier, as JAX's own
n_time = 4 case is.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax import lax
from jax import shard_map
from jax.sharding import PartitionSpec as P

import stnls_tpu
from stnls_tpu.parallel import make_mesh, time_sharded_search, \
    halo_gather, shard_search
from stnls_tpu.ops.nls import nls_search_volume_chunk, dist_type_select
from stnls_tpu.ops import anchor as anchor_ops
from stnls_tpu.ops import topk as topk_ops

from torch_port_helpers import assert_close, assert_grad_close, run_ranks, \
    unshard, parallel_jobs

TIME2 = {"time": 2}
# name: (data of make_data, time_sharded_search's keywords); "volume"
# ranks 69 slots, more than B1 keeps: the chunk runs on the volume route
SEARCH_CASES = {
    "base": (dict(T=8, F=3, H=8, W=8, wt=1, seed=0),
             dict(ws=3, wt=1, ps=1, k=4)),
    "anchor_ps3": (dict(T=4, F=3, H=16, W=16, wt=1, seed=7),
                   dict(ws=3, wt=1, ps=3, k=4, stride1=0.5,
                        self_action="anchor")),
    "volume": (dict(T=8, F=2, H=8, W=8, wt=1, seed=5),
               dict(ws=5, wt=1, ps=1, k=70, self_action="anchor")),
}
GATHER = dict(B=1, HD=1, T=8, F=3, H=8, W=8, K=4, ws=3, wt=1, ps=1)


def make_data(B=1, HD=1, T=8, F=3, H=8, W=8, wt=1, seed=0):
    """tests/parallel/test_sharding.py's inputs, as numpy."""
    rng = np.random.default_rng(seed)
    vid0 = rng.standard_normal((B, HD, T, F, H, W)).astype(np.float32)
    vid1 = rng.standard_normal((B, HD, T, F, H, W)).astype(np.float32)
    flows = rng.standard_normal((B, HD, T, 2 * wt, 2, H, W)) \
        .astype(np.float32)
    return dict(vid0=vid0, vid1=vid1, flows=flows)


def jax_search(arrays, kw, axes=TIME2, impl="lattice", **extra):
    """JAX's time_sharded_search on len(axes) devices: dists, inds and
    the gradients of the sum of the finite dists into both videos. Its
    outputs are global; on a data axis the batch is split as well."""
    n = int(np.prod(list(axes.values())))
    mesh = make_mesh(axes, devices=jax.devices()[:n])
    v0, v1, fl = (jnp.asarray(arrays[key]) for key in ("vid0", "vid1",
                                                        "flows"))

    def loss(a, b):
        d, i = time_sharded_search(a, b, fl, mesh, impl=impl, **kw, **extra)
        return jnp.sum(jnp.where(jnp.isfinite(d), d, 0.)), (d, i)

    (_, (d, i)), (g0, g1) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(v0, v1)
    return dict(dists=d, inds=i, g_vid0=g0, g_vid1=g1)


def dryrun_inputs(axes, F=8, H=12, W=12, HD=2, wt=1, seed=0):
    """The inputs as __graft_entry__.dryrun_multichip draws them."""
    B, T = 2 * axes["data"], 4 * axes["time"]
    W_t = 2 * wt + 1
    rng = np.random.default_rng(seed)
    vid = rng.standard_normal((B, T, F, H, W))
    tgt = rng.standard_normal((B, T, F, H, W))
    flows = 0.5 * rng.standard_normal((B, HD, T, W_t - 1, 2, H, W))
    params = {key: rng.standard_normal((F, F)) / 3.
              for key in ("q", "k", "v", "o")}
    return vid, tgt, flows, params


def jax_dryrun_step(axes, F=8, H=12, W=12, HD=2, ws=3, wt=1, ps=1, K=4):
    """One step of dryrun_multichip's train_step (its local_loss body,
    with JAX's halo_gather) on len(axes) devices: (new params, loss,
    grads)."""
    n = int(np.prod(list(axes.values())))
    mesh = make_mesh(axes, devices=jax.devices()[:n])
    vid, tgt, flows, params = (
        jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), x)
        for x in dryrun_inputs(axes, F, H, W, HD, wt))
    T = vid.shape[1]
    halo = 2 * wt
    gather = stnls_tpu.agg.NonLocalGather(ps=ps, stride0=1)

    def local_loss(p, vid_l, tgt_l, flows_l):
        Bl, Tl = vid_l.shape[:2]
        split = lambda x: x.reshape(Bl, Tl, HD, F // HD, H, W) \
            .transpose(0, 2, 1, 3, 4, 5)
        q6, k6, v6 = (split(jnp.einsum("btchw,cd->btdhw", vid_l, p[key]))
                      for key in ("q", "k", "v"))

        def _halo(x):
            nt = lax.axis_size("time")
            if nt == 1:
                pad = jnp.zeros_like(x[:, :, :halo])
                return jnp.concatenate([pad, x, pad], axis=2)
            fwd = [(i, (i + 1) % nt) for i in range(nt)]
            bwd = [(i, (i - 1) % nt) for i in range(nt)]
            left = lax.ppermute(x[:, :, -halo:], "time", fwd)
            right = lax.ppermute(x[:, :, :halo], "time", bwd)
            return jnp.concatenate([left, x, right], axis=2)

        t0 = lax.axis_index("time") * Tl
        dists, inds3 = nls_search_volume_chunk(
            _halo(q6), _halo(k6), flows_l, t0=t0, T_global=T, halo=halo,
            ws=ws, wt=wt, ps=ps, stride0=1, stride1=1, dist_type="l2")
        Q = Tl * H * W
        d = jnp.transpose(dists, (0, 1, 2, 6, 7, 3, 4, 5)) \
            .reshape(Bl, HD, Q, -1)
        i3 = jnp.transpose(inds3, (0, 1, 2, 3, 7, 8, 4, 5, 6)) \
            .reshape(3, Bl, HD, Q, -1)
        d, i3, _ = anchor_ops.anchor_self(d, i3)
        _, desc, _ = dist_type_select("l2")
        d, i3 = topk_ops.topk(d, i3, K, desc, anchor=True)
        d = d.reshape(Bl, HD, Tl, H, W, K)
        inds = jnp.moveaxis(i3.reshape(3, Bl, HD, Tl, H, W, K), 0, -1)
        w = jax.nn.softmax(-10. * d, axis=-1)
        stack = halo_gather(gather, v6, w, inds, wt)
        out = jnp.mean(stack, axis=2)
        out = out.transpose(0, 2, 1, 3, 4, 5).reshape(Bl, Tl, F, H, W)
        out = jnp.einsum("btchw,cd->btdhw", out, p["o"])
        return jnp.mean((out - tgt_l) ** 2)

    def train_step(p, vid, tgt, flows):
        loss, grads = jax.value_and_grad(local_loss)(p, vid, tgt, flows)
        grads = jax.tree.map(lambda g: lax.pmean(g, ("data", "time")), grads)
        loss = lax.pmean(loss, ("data", "time"))
        new_p = jax.tree.map(lambda w, g: w - 1e-2 * g, p, grads)
        return new_p, loss, grads

    step = jax.jit(shard_map(
        train_step, mesh=mesh,
        in_specs=(P(), P("data", "time"), P("data", "time"),
                  P("data", None, "time")),
        out_specs=(P(), P(), P()), check_vma=False))
    return step(params, vid, tgt, flows)


def _gather_case():
    """A full search's softmax weights and offsets (JAX), a cotangent of
    the stack, and JAX's halo_gather stack on two devices with the
    gradients of the full gather."""
    g = GATHER
    arrays = make_data(g["B"], g["HD"], g["T"], g["F"], g["H"], g["W"],
                       g["wt"], seed=3)
    search = stnls_tpu.search.NonLocalSearch(
        g["ws"], g["wt"], g["ps"], g["K"], stride0=1, dist_type="l2",
        itype="float", impl="lattice")
    d, inds = jax.jit(search)(*(jnp.asarray(arrays[key])
                               for key in ("vid0", "vid1", "flows")))
    w = jax.nn.softmax(-10. * d, axis=-1)
    gather = stnls_tpu.agg.NonLocalGather(ps=g["ps"], stride0=1)
    vid = jnp.asarray(arrays["vid1"])
    rng = np.random.default_rng(4)
    cot = rng.standard_normal(jax.eval_shape(gather, vid, w, inds).shape) \
        .astype(np.float32)
    mesh = make_mesh(TIME2, devices=jax.devices()[:2])
    fn = shard_map(lambda v, w_l, i_l: halo_gather(gather, v, w_l, i_l,
                                                   g["wt"]),
                   mesh=mesh, in_specs=(P(None, None, "time"),) * 3,
                   out_specs=P(None, None, None, "time"), check_vma=False)
    g_vid, g_w = jax.jit(jax.grad(
        lambda v, w_: jnp.sum(gather(v, w_, inds) * cot),
        argnums=(0, 1)))(vid, w)
    ref = dict(stack=jax.jit(fn)(vid, w, inds), g_vid=g_vid, g_weights=g_w)
    arrays = dict(vid=arrays["vid1"], weights=np.asarray(w),
                  inds=np.asarray(inds), cot=cot)
    return arrays, ref


@pytest.fixture(scope="module")
def world2():
    """The JAX references, then one spawn of two ranks running every job;
    returns (ranks' results, references)."""
    jobs, refs = [], {}
    for name, (data, kw) in SEARCH_CASES.items():
        arrays = make_data(**data)
        jobs.append(("search", name, TIME2, arrays, kw))
        refs[name] = jax_search(arrays, kw)
    arrays, refs["gather"] = _gather_case()
    jobs.append(("halo_gather", "gather", TIME2, arrays,
                 dict(ps=GATHER["ps"], wt=GATHER["wt"])))
    arrays = make_data(B=4, T=3, seed=1)
    skw = dict(ws=3, wt=1, ps=1, k=4, stride0=1, itype="float")
    jobs.append(("shard_search", "shard", {"data": 2}, arrays, skw))
    jmesh = make_mesh({"data": 2}, devices=jax.devices()[:2])
    jd, ji = jax.jit(shard_search(stnls_tpu.search.NonLocalSearch(
        impl="lattice", **skw), jmesh))(*(jnp.asarray(arrays[key]) for key
                                          in ("vid0", "vid1", "flows")))
    refs["shard"] = dict(dists=jd, inds=ji)
    axes = {"data": 1, "time": 2}
    jobs.append(("twin", "twin", axes, {}, {}))
    refs["twin"] = jax_dryrun_step(axes)
    return run_ranks(parallel_jobs, 2, jobs), refs


@pytest.mark.parametrize("name", list(SEARCH_CASES))
def test_time_sharded_search_matches_jax(world2, name):
    parts, refs = world2
    ref = refs[name]
    for key in ("dists", "inds", "g_vid0", "g_vid1"):
        ours = unshard(parts, f"{name}/{key}", TIME2, 2)
        assert ours.shape == ref[key].shape, key
        assert_close(ours, ref[key], f"{name} {key}")


def test_halo_gather_matches_jax(world2):
    parts, refs = world2
    ref = refs["gather"]
    assert_close(unshard(parts, "gather/stack", TIME2, 3), ref["stack"],
                 "stack")
    for key in ("g_vid", "g_weights"):
        assert_grad_close(unshard(parts, f"gather/{key}", TIME2, 2),
                          ref[key], key)


def test_shard_search_cuts_the_batch(world2):
    parts, refs = world2
    for key in ("dists", "inds"):
        assert parts[0][f"shard/{key}"].shape[0] == 2
        assert_close(unshard(parts, f"shard/{key}", {"data": 2}, 0),
                     refs["shard"][key], key)
    # data_head_specs' placements lay the video out by the same blocks
    np.testing.assert_array_equal(
        unshard(parts, "shard/vid0", {"data": 2}, 0),
        make_data(B=4, T=3, seed=1)["vid0"])


def test_twin_step_matches_the_dryrun_step(world2):
    parts, refs = world2
    new_p, loss, grads = refs["twin"]
    for part in parts:     # the mean over the mesh is every rank's
        assert_grad_close(part["twin/loss"], loss, "loss")
        for key in ("q", "k", "v", "o"):
            assert_grad_close(part[f"twin/grad_{key}"], grads[key],
                              f"grad {key}")
            assert_grad_close(part[f"twin/new_{key}"], new_p[key],
                              f"new {key}")
    assert np.isfinite(float(loss))


def test_twin_inputs_follow_the_dryrun():
    from stnls_tpu_torch import multichip_step as ms
    axes = ms.mesh_axes(4)
    assert axes == {"data": 2, "time": 2} and ms.mesh_axes(3) == \
        {"data": 3, "time": 1}
    vid, tgt, flows, params, cfg = ms.make_inputs(axes, device="cpu")
    ref = dryrun_inputs(axes)
    for ours, theirs in zip((vid, tgt, flows), ref[:3]):
        np.testing.assert_array_equal(ours.numpy(),
                                      theirs.astype(np.float32))
    for key in ("q", "k", "v", "o"):
        np.testing.assert_array_equal(params[key].numpy(),
                                      ref[3][key].astype(np.float32))


def test_plain_weights_pass_through_params_from_jax():
    """The twin's {q, k, v, o} [F,F] are plain weights outside any flax
    module: convert.params_from_jax hands them over unchanged."""
    from stnls_tpu_torch.convert import params_from_jax
    rng = np.random.default_rng(2)
    params = {key: rng.standard_normal((8, 8)).astype(np.float32)
              for key in ("q", "k", "v", "o")}
    state = params_from_jax(params)
    assert set(state) == set(params)
    for key, val in params.items():
        np.testing.assert_array_equal(state[key].numpy(), val)
    assert params_from_jax({"params": params}).keys() == state.keys()


@pytest.mark.slow
def test_mesh_2x2_matches_jax():
    """The 2 x 2 mesh of dryrun_multichip(4): the search with the batch
    over "data" and the frames over "time", and the twin's step."""
    axes = {"data": 2, "time": 2}
    data, kw = SEARCH_CASES["base"]
    arrays = make_data(**dict(data, B=2))
    jobs = [("search", "base", axes, arrays, kw), ("twin", "twin", axes, {},
                                                   {})]
    parts = run_ranks(parallel_jobs, 4, jobs)
    ref = jax_search(arrays, kw, axes)
    for key in ("dists", "inds", "g_vid0", "g_vid1"):
        assert_close(unshard(parts, f"base/{key}", axes, 2), ref[key], key)
    new_p, loss, grads = jax_dryrun_step(axes)
    for part in parts:
        assert_grad_close(part["twin/loss"], loss, "loss")
        for key in ("q", "k", "v", "o"):
            assert_grad_close(part[f"twin/new_{key}"], new_p[key], key)


@pytest.mark.slow
def test_time_sharded_search_matches_jax_pallas_chunks():
    """JAX's fused Pallas chunk path (query_t0/T_global mode, interpret
    kernels), as tests/parallel/test_sharding.py runs it."""
    arrays = make_data(T=4, H=16, W=16, wt=1, seed=7)
    kw = dict(ws=3, wt=1, ps=3, k=4, stride0=1, dist_type="l2",
              itype="float", self_action="anchor")
    parts = run_ranks(parallel_jobs, 2, [("search", "p", TIME2, arrays,
                                          kw)])
    ref = jax_search(arrays, kw, impl="pallas", flow_budget=6,
                     spread_budget=8)
    for key in ("dists", "inds", "g_vid0", "g_vid1"):
        assert_close(unshard(parts, f"p/{key}", TIME2, 2), ref[key], key)
