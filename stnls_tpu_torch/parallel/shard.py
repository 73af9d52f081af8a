"""SPMD execution of the search pipeline (PyTorch port of
stnls_tpu/parallel/shard.py), on torch.distributed.

Two modes, as in the JAX package:
  * `shard_search` -- (B, HD) sharding: the search volume is independent
    per (batch, head), so each rank searches its own block of the inputs,
    with no collectives;
  * `time_sharded_search` / `TimeShardedSearch` -- context parallelism
    over the frame axis: each rank holds T/n frames, `_halo_exchange`
    swaps a 2*wt-frame halo with its ring neighbours (point-to-point sends
    over the mesh's time group) and the rank body `chunk_search` runs the
    search on the local queries with the whole sequence's boundary-shifted
    time windows: B1/B2 or B5/B6 in their temporal-chunk mode (the plain
    versions on CPU tensors). The halo's gradients travel back to the
    frames' owners in `_halo_exchange`'s backward, the transposed exchange
    that JAX's ppermute gets from autodiff.

The difference from JAX's API: JAX's functions take and return global
arrays laid out over the mesh by shard_map. Here, as torch.distributed
programs are written, every rank calls them with its own local shards
([B,HD,T_local,...]) and gets its local outputs. The TPU-only knobs
(impl, flow_budget, spread_budget) are accepted and do nothing.
"""

import torch
import torch.distributed as dist

from stnls_tpu_torch.search.non_local_search import nls_pipeline, \
    extract_config


def _block(x, dim, mesh, axis):
    """This rank's block of x along `dim`, x's extent cut evenly over the
    mesh axis `axis`."""
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    if x.shape[dim] % n:
        raise ValueError(f"{x.shape[dim]} items of dim {dim} do not divide "
                         f"over the {n} ranks of mesh axis {axis!r}")
    size = x.shape[dim] // n
    return x.narrow(dim, mesh.get_local_rank(axis) * size, size)


def shard_search(search, mesh, data_axis="data", head_axis=None):
    """Wrap a NonLocalSearch-like module so that each rank searches its
    (B, HD) block: run(vid0, vid1, flows) takes the whole inputs
    (vid [B,HD,T,F,H,W], flows [B,HDf,...]) on every rank and returns the
    search of this rank's block, batch cut over `data_axis` and heads over
    `head_axis` (flows with one head shared are not cut). No
    collectives."""

    def run(vid0, vid1, flows):
        HD = vid0.shape[1]
        vid0, vid1, flows = (_block(x, 0, mesh, data_axis)
                             for x in (vid0, vid1, flows))
        if head_axis is not None:
            vid0, vid1 = (_block(x, 1, mesh, head_axis) for x in (vid0, vid1))
            if flows.shape[1] == HD:
                flows = _block(flows, 1, mesh, head_axis)
        return search(vid0, vid1, flows)

    return run


def _ring_swap(group, to_next, to_prev):
    """Send to_next to the next rank and to_prev to the previous one on
    the ring of `group`; return (from_prev, from_next). The two directions
    carry distinct tags, so that on a ring of two, where both neighbours
    are one rank, gloo tells them apart; NCCL matches them in issue order,
    which is the same on every rank."""
    n, i = dist.get_world_size(group), dist.get_rank(group)
    prev = dist.get_global_rank(group, (i - 1) % n)
    nxt = dist.get_global_rank(group, (i + 1) % n)
    to_next, to_prev = to_next.contiguous(), to_prev.contiguous()
    from_prev, from_next = torch.empty_like(to_next), torch.empty_like(to_prev)
    ops = [dist.P2POp(dist.isend, to_next, nxt, group, tag=0),
           dist.P2POp(dist.irecv, from_prev, prev, group, tag=0),
           dist.P2POp(dist.isend, to_prev, prev, group, tag=1),
           dist.P2POp(dist.irecv, from_next, nxt, group, tag=1)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return from_prev, from_next


class _HaloExchange(torch.autograd.Function):
    """Forward: x [B,HD,T,...] -> [B,HD,T+2h,...], the previous rank's
    last h frames before x and the next rank's first h frames after it.
    Backward: each halo's gradient goes back to the rank that owns its
    frames, which adds it to its edge frames."""

    @staticmethod
    def forward(ctx, x, group, halo):
        ctx.group, ctx.halo = group, halo
        left, right = _ring_swap(group, x[:, :, -halo:], x[:, :, :halo])
        return torch.cat([left, x, right], dim=2)

    @staticmethod
    def backward(ctx, g):
        h = ctx.halo
        g_x = g[:, :, h:-h].clone()
        to_first, to_last = _ring_swap(ctx.group, g[:, :, -h:], g[:, :, :h])
        g_x[:, :, :h] += to_first
        g_x[:, :, -h:] += to_last
        return g_x, None, None


def _halo_exchange(x, mesh, time_axis, halo):
    """Ring halo exchange along the time-sharded axis: x [B,HD,T_local,...]
    padded with `halo` frames from each ring neighbour on axis 2 (the
    wrap-around frames at the sequence ends are never read by the chunked
    search); zeros when the axis has one rank. Differentiable."""
    if halo == 0:
        return x
    group = mesh.get_group(time_axis)
    if dist.get_world_size(group) == 1:
        pad = x.new_zeros(x.shape[:2] + (halo,) + x.shape[3:])
        return torch.cat([pad, x, pad], dim=2)
    if x.shape[2] < halo:
        raise ValueError(f"a time shard of {x.shape[2]} frames is shorter "
                         f"than the halo of {halo} frames its neighbours "
                         "need: use fewer ranks on the time axis")
    return _HaloExchange.apply(x, group, halo)


def halo_gather(gather, v6, weights, inds, wt, mesh, time_axis="time"):
    """Aggregation under temporal context parallelism without gathering
    the whole value video: search offsets reach |dt| <= 2*wt, so a
    2*wt-frame ring halo of v suffices.

    gather:  NonLocalGather-like callable (vid, weights, inds) -> stack
    v6:      [B,HD,T_local,F,H,W] local value shard
    weights: [B,HD,T_local,nH,nW,K]
    inds:    [B,HD,T_local,nH,nW,K,3] relative (dt,dh,dw) offsets
    Returns the local stack [B,HD,K,T_local,F,H,W]. Per-rank memory is
    O(T_local + 4*wt) frames. Differentiable (the halo's gradients go back
    to their owners)."""
    halo = 2 * wt
    Tl = weights.shape[2]
    if halo == 0:
        return gather(v6, weights, inds)
    v_h = _halo_exchange(v6, mesh, time_axis, halo)   # [B,HD,Tl+2h,...]

    def pad_t(x):
        pad = x.new_zeros(x.shape[:2] + (halo,) + x.shape[3:])
        return torch.cat([pad, x, pad], dim=2)

    # halo-frame query rows carry zero weights and only write their own
    # (cropped) stack frames, so the crop below is exact
    stack = gather(v_h, pad_t(weights), pad_t(inds))
    return stack[:, :, :, halo:halo + Tl]


def chunk_search(v0p, v1p, fl, *, t0, T_global, halo, ws, wt, ps, k,
                 stride0=1, stride1=1, dist_type="l2", self_action=None,
                 itype="float", dilation=1, full_ws=True, use_adj=False):
    """The rank body of the time-sharded search (JAX's `chunk_fn`).

    v0p, v1p [B,HD,T_local+2*halo,F,H,W]: the local frames with their
    halos; fl [B,HDf,T_local,W_t(-1),2,nH,nW]; t0 the global index of the
    first local frame of a sequence of T_global frames. Returns (dists
    [B,HD,T_local,nH,nW,K], inds [...,K,3]) of the local queries,
    differentiable in v0p, v1p and the flows. The search anchors the self
    cell when self_action names an anchor and ranks the top-k over all
    window cells, as JAX's chunk does: through B1/B2 where
    search.non_local_search.search_route takes the lazy top-K (B1 and B2
    in chunk mode), else through the volume B5/B6 in chunk mode and the
    torch top-K."""
    if v0p.shape[2] - 2 * halo != fl.shape[2]:
        raise ValueError("v0p/v1p must hold the flows' frames plus halo "
                         "frames on each side")
    anchor = self_action is not None and "anchor" in self_action
    cfg = extract_config(dict(
        ws=ws, wt=wt, ps=ps, k=k, stride0=stride0, stride1=stride1,
        dist_type=dist_type, self_action="anchor" if anchor else None,
        itype=itype, dilation=dilation, full_ws=full_ws, use_adj=use_adj))
    return nls_pipeline(v0p, v1p, fl, cfg, query_t0=t0, T_global=T_global)


def time_sharded_search(vid0, vid1, flows, mesh, *, ws, wt, ps, k,
                        stride0=1, stride1=1, dist_type="l2",
                        self_action=None, itype="float", time_axis="time",
                        impl="auto", flow_budget=8, spread_budget=8, **kw):
    """Full flow-shifted search with the T axis sharded over `time_axis`.

    Each rank passes its local shards vid0/vid1 [B,HD,T_local,F,H,W] and
    flows [B,HDf,T_local,W_t-1,2,nH,nW] (the frames of its place on the
    time axis) and gets its local (dists [B,HD,T_local,nH,
    nW,K], inds [...,K,3]), where JAX's version takes and returns global
    arrays: the sequence holds T_local times the time axis' ranks frames,
    every rank the same T_local. Differentiable in the shards: the
    gradients of the halo frames reach their owners. kw: dilation,
    full_ws, use_adj. impl, flow_budget, spread_budget are the TPU's
    knobs and do nothing."""
    n = mesh.size(mesh.mesh_dim_names.index(time_axis))
    T_local = vid0.shape[2]
    T = n * T_local
    halo = 2 * wt
    t0 = mesh.get_local_rank(time_axis) * T_local
    v0p = _halo_exchange(vid0, mesh, time_axis, halo)
    v1p = _halo_exchange(vid1, mesh, time_axis, halo)
    return chunk_search(v0p, v1p, flows, t0=t0, T_global=T, halo=halo, ws=ws,
                        wt=wt, ps=ps, k=k, stride0=stride0, stride1=stride1,
                        dist_type=dist_type, self_action=self_action,
                        itype=itype, **kw)


class TimeShardedSearch(torch.nn.Module):
    """Module-style wrapper around time_sharded_search: forward(vid0,
    vid1, flows) on each rank's local shards."""

    def __init__(self, mesh, ws, wt, ps=1, k=10, stride0=1, stride1=1,
                 dist_type="l2", self_action=None, itype="float",
                 time_axis="time"):
        super().__init__()
        self.mesh = mesh
        self.kw = dict(ws=ws, wt=wt, ps=ps, k=k, stride0=stride0,
                       stride1=stride1, dist_type=dist_type,
                       self_action=self_action, itype=itype,
                       time_axis=time_axis)

    def forward(self, vid0, vid1, flows):
        return time_sharded_search(vid0, vid1, flows, self.mesh, **self.kw)
