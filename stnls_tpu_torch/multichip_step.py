"""The multichip training step of __graft_entry__.dryrun_multichip, in
PyTorch on torch.distributed.

One SPMD training step on a (data, time) mesh: batch data parallel times
temporal context parallel. Each rank holds its batch block and its frames
(`local_shards`) and runs `local_loss`: q, k, v = einsum with [F,F]
weights, split into heads; the search of its queries against the keys
with a 2*wt-frame ring halo (`parallel.shard._halo_exchange` and the rank
body `parallel.shard.chunk_search`: B1/B2 in temporal-chunk mode on the
card); softmax(-10 d); `parallel.halo_gather` of the values with
NonLocalGather (B3/B4); the mean over the K neighbours; the output einsum;
the MSE to the target. `train_step` averages the loss and the gradients
over the whole mesh (all_reduce) and takes an SGD step at 1e-2, as the
dryrun's pmean and update do.

`mesh_axes(n)` factors n ranks as the dryrun does (two on the time axis
when n is even), and `dryrun_mesh` builds that (data, time) mesh over
every rank of an initialised process group (NCCL on the card, gloo on
the CPU); `one_rank_mesh` gives a single process its own group and mesh,
to run the step or time_sharded_search on one card. `make_inputs` draws
the dryrun's inputs from a numpy seed in its order (B = 2 n_data, T =
4 n_time) with its widths as defaults (`CONFIG`), and `train` takes SGD
steps from them.
"""

import contextlib

import numpy as np
import torch
import torch.distributed as dist

from stnls_tpu_torch import convert
from stnls_tpu_torch.agg.gather import NonLocalGather
from stnls_tpu_torch.parallel.mesh import make_mesh
from stnls_tpu_torch.parallel.shard import _block, _halo_exchange, \
    chunk_search, halo_gather

# the dryrun's widths (__graft_entry__.dryrun_multichip), and the bench
# slice's (bench.py:71-75), at which chip_smoke.py and profile_step.py run
# the step on the card
CONFIG = dict(F=8, H=12, W=12, HD=2, ws=3, wt=1, ps=1, K=4, stride1=1)
BENCH_WIDTHS = dict(F=16, HD=2, H=128, W=128, ws=5, wt=2, ps=3, K=10,
                    stride1=0.5)
LR = 1e-2


def mesh_axes(n_ranks):
    """{"data": n_data, "time": n_time}: two ranks on the time axis when
    n_ranks is even, as the dryrun factors its devices."""
    n_time = 2 if n_ranks % 2 == 0 else 1
    return {"data": n_ranks // n_time, "time": n_time}


def dryrun_mesh(device_type="cuda"):
    """The dryrun's (data, time) mesh over every rank of the initialised
    process group."""
    return make_mesh(mesh_axes(dist.get_world_size()), device_type)


@contextlib.contextmanager
def one_rank_mesh(device_type="cuda"):
    """A process group of this process alone (NCCL on the card, gloo on
    the CPU) and the dryrun's mesh of it; the group is destroyed on
    exit."""
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield dryrun_mesh(device_type)
    finally:
        dist.destroy_process_group()


def make_inputs(axes, seed=0, device="cuda", **widths):
    """The dryrun's global inputs for a mesh of `axes`, from numpy seed
    `seed` in its order: vid, tgt [B,T,F,H,W], flows [B,HD,T,W_t-1,2,H,W]
    (0.5 * normal), and the parameters {q, k, v, o} [F,F] (normal / 3,
    carried over by convert.params_from_jax), with B = 2 n_data and T =
    4 n_time. Returns (vid, tgt, flows, params, cfg)."""
    cfg = dict(CONFIG, **widths)
    B, T = 2 * axes["data"], 4 * axes["time"]
    F, H, W, HD, wt = (cfg[key] for key in ("F", "H", "W", "HD", "wt"))
    W_t = min(2 * wt + 1, T)
    rng = np.random.default_rng(seed)
    vid = rng.standard_normal((B, T, F, H, W)).astype(np.float32)
    tgt = rng.standard_normal((B, T, F, H, W)).astype(np.float32)
    flows = (0.5 * rng.standard_normal((B, HD, T, W_t - 1, 2, H, W))) \
        .astype(np.float32)
    params = {name: (rng.standard_normal((F, F)) / 3.).astype(np.float32)
              for name in ("q", "k", "v", "o")}
    params = {name: x.to(device) for name, x in
              convert.params_from_jax(params).items()}
    return tuple(torch.from_numpy(x).to(device) for x in (vid, tgt, flows)) \
        + (params, cfg)


def local_shards(mesh, vid, tgt, flows):
    """This rank's block of the global inputs: the batch cut over "data",
    the frames over "time"."""
    out = []
    for x, t_dim in ((vid, 1), (tgt, 1), (flows, 2)):
        out.append(_block(_block(x, 0, mesh, "data"), t_dim, mesh, "time")
                   .contiguous())
    return tuple(out)


def local_loss(params, vid_l, tgt_l, flows_l, mesh, cfg, T_global):
    """The dryrun's local_loss on this rank's shards: vid_l, tgt_l
    [B_l,T_l,F,H,W], flows_l [B_l,HD,T_l,W_t-1,2,H,W]."""
    Bl, Tl, F, H, W = vid_l.shape
    HD, ws, wt, ps, K = (cfg[key] for key in ("HD", "ws", "wt", "ps", "K"))
    halo = 2 * wt

    def split(x):
        return x.reshape(Bl, Tl, HD, F // HD, H, W).transpose(1, 2)

    q6, k6, v6 = (split(torch.einsum("btchw,cd->btdhw", vid_l, params[key]))
                  for key in ("q", "k", "v"))
    t0 = mesh.get_local_rank("time") * Tl
    dists, inds = chunk_search(
        _halo_exchange(q6, mesh, "time", halo),
        _halo_exchange(k6, mesh, "time", halo), flows_l, t0=t0,
        T_global=T_global, halo=halo, ws=ws, wt=wt, ps=ps, k=K, stride0=1,
        stride1=cfg["stride1"], dist_type="l2", self_action="anchor")
    weights = torch.softmax(-10. * dists, dim=-1)
    gather = NonLocalGather(ps=ps, stride0=1)
    stack = halo_gather(gather, v6.contiguous(), weights, inds, wt, mesh)
    out = stack.mean(dim=2).transpose(1, 2).reshape(Bl, Tl, F, H, W)
    out = torch.einsum("btchw,cd->btdhw", out, params["o"])
    return ((out - tgt_l) ** 2).mean()


def train_step(params, vid_l, tgt_l, flows_l, mesh, cfg, T_global, lr=LR):
    """The loss and gradients of `local_loss`, averaged over every rank of
    the mesh, and one SGD step. Returns (new params, loss, grads)."""
    p = {key: x.detach().requires_grad_() for key, x in params.items()}
    loss = local_loss(p, vid_l, tgt_l, flows_l, mesh, cfg, T_global)
    grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
    loss = loss.detach()
    n = dist.get_world_size()
    for x in [loss] + list(grads.values()):
        dist.all_reduce(x)
        x /= n
    return {key: p[key].detach() - lr * grads[key] for key in p}, loss, grads


def train(mesh, vid, tgt, flows, params, cfg, steps=1, lr=LR):
    """`steps` SGD steps from the global inputs (those of make_inputs, in
    its order); returns (params, [(loss, grads) of each step])."""
    shards = local_shards(mesh, vid, tgt, flows)
    history = []
    for _ in range(steps):
        params, loss, grads = train_step(params, *shards, mesh, cfg,
                                         vid.shape[1], lr)
        history.append((loss, grads))
    return params, history

