"""Helpers of the port's parity tests: numpy -> torch, and the stated
tolerances."""

import numpy as np
import torch

TOL = 1e-4   # atol = rtol for forward outputs (BASELINE correctness target)


def to_torch(x, grad=False):
    return torch.from_numpy(np.array(x, dtype=np.float32)).requires_grad_(grad)


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_close(port, ref, what="", atol=TOL, rtol=TOL):
    np.testing.assert_allclose(to_np(port), to_np(ref), atol=atol, rtol=rtol,
                               err_msg=what)


def assert_grad_close(port, ref, what="", tol=TOL):
    """Gradients: atol = tol * max|g| (sums run in another order)."""
    ref = to_np(ref)
    scale = max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(to_np(port), ref, atol=tol * scale, rtol=0,
                               err_msg=what)


def assert_cells_match(cells, ref_cells, ref_dists):
    """Cells equal except at near-ties of the reference's ranked dists."""
    cells, ref_cells, d = to_np(cells), to_np(ref_cells), to_np(ref_dists)
    gap = np.abs(np.diff(d, axis=-1)) <= TOL * (1 + np.abs(d[..., 1:]))
    tie = np.zeros(d.shape, bool)
    tie[..., 1:] |= gap
    tie[..., :-1] |= gap
    tie[..., -1] = True
    assert ((cells == ref_cells) | tie).all()
    assert (cells == ref_cells).mean() > 0.99


# -- spawned ranks (tests/torch_port/test_torch_parallel.py) --
# Each rank is a fresh process that imports this module, torch and the
# port, never JAX. Limits: gloo gives up on a stuck peer after
# RANK_TIMEOUT seconds, and run_ranks kills the ranks and fails after
# JOIN_TIMEOUT, so a hang costs about two minutes, not the suite's limit.
RANK_TIMEOUT, JOIN_TIMEOUT = 60, 120


def _rank_main(worker, rank, world, tmp, args):
    import datetime
    import traceback
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{tmp}/store", rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=RANK_TIMEOUT))
        out = worker(rank, world, *args)
        np.savez(f"{tmp}/rank{rank}.npz", **out)
    except BaseException:
        with open(f"{tmp}/rank{rank}.err", "w") as fh:
            fh.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(worker, world, *args, timeout=JOIN_TIMEOUT):
    """worker(rank, world, *args) -> dict of numpy arrays, run in `world`
    spawned processes joined by a gloo process group; returns the ranks'
    dicts. Fails if a rank fails, or kills them all and fails when they
    have not ended after `timeout` seconds."""
    import multiprocessing
    import tempfile
    import time
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_rank_main,
                             args=(worker, rank, world, tmp, args))
                 for rank in range(world)]
        for proc in procs:
            proc.start()
        deadline = time.monotonic() + timeout
        for proc in procs:
            proc.join(max(0., deadline - time.monotonic()))
        hung = [rank for rank, proc in enumerate(procs) if proc.is_alive()]
        for proc in procs:
            if proc.is_alive():
                proc.kill()
            proc.join()
        assert not hung, f"ranks {hung} still ran after {timeout} s"
        errors = []
        for rank, proc in enumerate(procs):
            if proc.exitcode != 0:
                try:
                    with open(f"{tmp}/rank{rank}.err") as fh:
                        errors.append(f"rank {rank}:\n{fh.read()}")
                except FileNotFoundError:
                    errors.append(f"rank {rank}: exit code {proc.exitcode}")
        assert not errors, "\n".join(errors)
        return [dict(np.load(f"{tmp}/rank{rank}.npz"))
                for rank in range(world)]


def halo_chunk(x, t0, T_local, halo):
    """Frames t0 - halo .. t0 + T_local + halo - 1 of a whole sequence x
    [B,HD,T,...], zeros beyond its ends: the padded chunk a rank's search
    runs on, as the ring exchange of a single time shard builds it."""
    T = x.shape[2]
    lo, hi = max(0, t0 - halo), min(T, t0 + T_local + halo)
    out = x.new_zeros(x.shape[:2] + (T_local + 2 * halo,) + x.shape[3:])
    out[:, :, lo - t0 + halo:hi - t0 + halo] = x[:, :, lo:hi]
    return out.contiguous()


def unshard(parts, key, axes, t_dim, b_dim=0):
    """The global array of `key` from the ranks' local parts (the rank
    order of a row-major mesh of `axes`, a dict of axis -> size): the
    time blocks joined along t_dim, the data blocks along b_dim."""
    n_data, n_time = axes.get("data", 1), axes.get("time", 1)
    rows = [np.concatenate([parts[d * n_time + t][key]
                            for t in range(n_time)], axis=t_dim)
            for d in range(n_data)]
    return np.concatenate(rows, axis=b_dim)


def _finite_sum(d):
    return torch.where(d.isfinite(), d, torch.zeros_like(d)).sum()


def parallel_jobs(rank, world, jobs):
    """Run the port's parallel/ functions on this rank; jobs is a list of
    (kind, name, mesh axes, arrays, kwargs). Returns {name/key: array}.
      search: time_sharded_search on the local shards of vid0, vid1,
        flows: dists, inds and the gradients of the sum of the finite
        dists into vid0 and vid1;
      halo_gather: NonLocalGather(ps) through halo_gather on the local
        shards of vid, weights and inds: stack, and the gradient of
        sum(stack * cot) into vid and weights;
      shard_search: NonLocalSearch(**kwargs) through shard_search: dists
        and inds of this rank's batch block, and vid0 laid out by
        named(mesh, data_head_specs(mesh)[0]) as a DTensor: its local
        block;
      twin: multichip_step's train step on its dryrun_mesh (whose axes
        must be `axes`) from make_inputs(axes, **kwargs) on the CPU: loss,
        grads and new params."""
    from stnls_tpu_torch import multichip_step as ms
    from stnls_tpu_torch.agg.gather import NonLocalGather
    from torch.distributed.tensor import distribute_tensor
    from stnls_tpu_torch.parallel import make_mesh, time_sharded_search, \
        halo_gather, shard_search, data_head_specs
    from stnls_tpu_torch.parallel.mesh import named
    from stnls_tpu_torch.parallel.shard import _block
    from stnls_tpu_torch.search.non_local_search import NonLocalSearch
    out = {}
    for kind, name, axes, arrays, kw in jobs:
        mesh = make_mesh(axes, "cpu")
        x = {key: torch.from_numpy(val) for key, val in arrays.items()}

        def local(t, t_dim=2):
            if "data" in axes:
                t = _block(t, 0, mesh, "data")
            return _block(t, t_dim, mesh, "time").contiguous()

        if kind == "search":
            v0, v1 = (local(x[key]).requires_grad_() for key in ("vid0",
                                                                 "vid1"))
            d, i = time_sharded_search(v0, v1, local(x["flows"]), mesh, **kw)
            g0, g1 = torch.autograd.grad(_finite_sum(d), (v0, v1))
            res = dict(dists=d, inds=i, g_vid0=g0, g_vid1=g1)
        elif kind == "halo_gather":
            v = local(x["vid"]).requires_grad_()
            w = local(x["weights"]).requires_grad_()
            stack = halo_gather(NonLocalGather(ps=kw["ps"], stride0=1), v, w,
                                local(x["inds"]), kw["wt"], mesh)
            g_v, g_w = torch.autograd.grad(
                (stack * local(x["cot"], 3)).sum(), (v, w))
            res = dict(stack=stack, g_vid=g_v, g_weights=g_w)
        elif kind == "shard_search":
            run = shard_search(NonLocalSearch(**kw), mesh)
            d, i = run(x["vid0"], x["vid1"], x["flows"])
            spec = named(mesh, data_head_specs(mesh)[0])
            res = dict(dists=d, inds=i, vid0=distribute_tensor(
                x["vid0"], *spec).to_local())
        elif kind == "twin":
            mesh = ms.dryrun_mesh("cpu")
            assert dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)) == axes
            vid, tgt, flows, params, cfg = ms.make_inputs(axes, device="cpu",
                                                          **kw)
            new, history = ms.train(mesh, vid, tgt, flows, params, cfg)
            loss, grads = history[0]
            res = dict(loss=loss, **{f"new_{k}": v for k, v in new.items()},
                       **{f"grad_{k}": v for k, v in grads.items()})
        else:
            raise ValueError(kind)
        out.update({f"{name}/{key}": val.detach().numpy()
                    for key, val in res.items()})
    return out


# RVRT at a small size: T 6 frames (three clips, so that the _2 branches
# read the _1 branches' updated flows) of 32^2, RVRT's own groups, window
# (2, 4, 4) over the 8^2 features
RVRT_SMALL = dict(B=1, T=6, H=32, W=32, in_chans=4, embed_dim=24,
                  num_heads=2, window_size=[2, 4, 4], num_blocks=[1, 2, 1],
                  depth=2, mlp_ratio=2, inputconv_groups=[1, 3, 4, 6, 8, 4],
                  attention_heads=2, ws=3, K=4)
RVRT_MODEL_KEYS = ("in_chans", "embed_dim", "num_heads", "window_size",
                   "num_blocks", "depth", "mlp_ratio", "inputconv_groups",
                   "attention_heads", "ws")


def rvrt_case(seed=0, **size):
    """(cfg, params, clip) of RVRT at RVRT_SMALL (entries replaced by
    `size`): weights uniform within 1/sqrt(fan-in) (relative-position
    tables within 0.02, LayerNorms at 1 and 0) from a torch.Generator;
    clip {lq [B,T,4,H,W], clean, fflow, bflow [B,T-1,2,H/4,W/4]}."""
    from bench_h100.reference import rvrt256 as rvrt_reference
    cfg = dict(RVRT_SMALL, **size)
    gen = torch.Generator().manual_seed(seed)
    params = {}
    for name, (shape, init) in rvrt_reference.parameter_shapes(cfg).items():
        if init[0] in ("one", "zero"):
            params[name] = torch.full(shape, float(init[0] == "one"))
            continue
        bound = init[1] ** -0.5 if init[0] == "fan" else 0.02
        params[name] = (torch.rand(shape, generator=gen) * 2 - 1) * bound
    B, T, H, W = (cfg[k] for k in "BTHW")
    clean = torch.randn((B, T, 3, H, W), generator=gen)
    sigma = torch.rand((B, 1, 1, 1, 1), generator=gen) * 0.2
    noisy = clean + sigma * torch.randn((B, T, 3, H, W), generator=gen)
    flows = [2. * (torch.rand((B, T - 1, 2, H // 4, W // 4), generator=gen)
                   * 2 - 1) for _ in range(2)]
    clip = dict(lq=torch.cat([noisy, sigma.expand(B, T, 1, H, W)], 2),
                clean=clean, fflow=flows[0], bflow=flows[1])
    return cfg, params, clip


def rvrt_train_step(cfg, params, clip, device):
    """The port's RVRT on `device`: out, the loss mean((out - clean)^2),
    every parameter's gradient and the alignments' selections, as the
    reference's judge reads them (on the CPU)."""
    from stnls_tpu_torch.models import RVRT
    net = RVRT(k=cfg["K"], **{k: cfg[k] for k in RVRT_MODEL_KEYS})
    net.load_state_dict(params)
    net.to(device)
    c = {k: v.to(device) for k, v in clip.items()}
    selections = []
    out = net(c["lq"], c["fflow"], c["bflow"], selections)
    loss = (out.contiguous() - c["clean"]).pow(2).mean()
    names, leaves = zip(*net.named_parameters())
    grads = torch.autograd.grad(loss, leaves)
    cpu = torch.device("cpu")
    return dict(out=out.detach().to(cpu), loss=loss.detach().to(cpu),
                grads={n: g.to(cpu) for n, g in zip(names, grads)},
                align=[{k: v.to(cpu) for k, v in s.items()}
                       for s in selections])
