"""B5 and B6: the full search volume forward and its backward (CUDA,
Hopper).

B5 mirrors stnls_tpu/ops/nls_pallas.py::nls_pallas_volume. `nls_volume`
launches csrc/nls_vol_fwd.cu on CUDA tensors and returns the distance of
every window cell, dists [B,HD,T,W_t,ws,ws,nH,nW], init-valued (+inf for
l2, -inf for prod) outside the frame. It takes the reflected search
centres (ops/nls.search_centres), not the flows: the flow walk stays in
torch, so autograd chains the centres' gradients to the flows.

B6 mirrors stnls_tpu/ops/nls_pallas_bwd.py::vol_bwd_pallas.
`search_volume` is the torch.autograd.Function around the two, as the
custom_vjp `_vol_op` is in the JAX package: its forward is B5, its
backward `nls_volume_bwd`, which launches csrc/nls_vol_bwd.cu and returns
the gradients to both videos and to the centres.

`nls_volume_plain` (ops/nls.volume_at_centres) and
`nls_volume_bwd_plain` (its VJP) are the kernels' plain PyTorch versions.
The wrappers take them only for tensors on the CPU; for a CUDA tensor they
launch the kernel or raise.

All of them take the temporal-chunk mode of time sharding, as
nls_pallas_volume does (B12): with query_t0 and T_global the videos hold
the T_local query frames plus `halo` frames on each side (halo = (T_v -
T_local) / 2 >= 2*wt), the centres and the volume the T_local query
frames, and the windows are the whole sequence's (ops/nls.chunk_frames).
"""

import torch

from stnls_tpu_torch.ops import cuda_lib
from stnls_tpu_torch.ops.geometry import num_queries
from stnls_tpu_torch.ops.nls import volume_at_centres, chunk_frames


# B5 takes its body with ps and F compiled in for the pairs
# csrc/nls_vol_fwd.cu lists (B1's counterpart: ops/nls_cuda.COMPILED_BODY);
# False forces the run-time body. B6 has only its run-time body.
COMPILED_BODY = True


def _stride1(stride1, itype):
    return float(max(1, int(stride1))) if itype == "int" else float(stride1)


# Plain version of B5: ops/nls.lattice_search over the window frames at
# the centres (differentiable). Same arguments and output as `nls_volume`.
nls_volume_plain = volume_at_centres


def _check(name, vid0, vid1, ctr_h, ctr_w, cfg, extra=()):
    """Raise on what B5/B6 do not take; returns the shapes and the chunk
    (t0, T_global, halo)."""
    B, HD, T_v, F, H, W = vid0.shape
    for what, x in (("vid0", vid0), ("vid1", vid1), ("ctr_h", ctr_h),
                    ("ctr_w", ctr_w)) + tuple(extra):
        if x.device != vid0.device or x.dtype != torch.float32:
            raise TypeError(f"{name}: {what} must be float32 on vid0's CUDA "
                            "device")
    T = ctr_h.shape[2]
    chunk = chunk_frames(T, T_v, cfg["wt"], cfg.get("query_t0"),
                         cfg.get("T_global"))
    W_t = min(2 * cfg["wt"] + 1, chunk[1])
    nH, nW = num_queries(H, W, cfg["stride0"])
    if vid0.ndim != 6 or vid1.shape != vid0.shape or \
            ctr_h.shape != (B, HD, T, W_t, nH, nW) or \
            ctr_w.shape != ctr_h.shape:
        raise ValueError(f"{name}: vid0/vid1 [B,HD,T,F,H,W] and centres "
                         "[B,HD,T,W_t,nH,nW] expected")
    if cfg["ps"] < 1 or F < 1:
        raise ValueError(f"{name}: need ps >= 1 and F >= 1")
    if cfg["dist_type"] not in ("l2", "prod") or \
            cfg["itype"] not in ("float", "int"):
        raise ValueError(f"{name}: dist_type={cfg['dist_type']!r}, "
                         f"itype={cfg['itype']!r}")
    if cfg["ws"] < 1 or cfg["wt"] < 0 or cfg["stride0"] < 1 or \
            not cfg["stride1"] > 0:
        raise ValueError(f"{name}: need ws >= 1, wt >= 0, stride0 >= 1, "
                         "stride1 > 0")
    if int(cfg["dilation"]) != cfg["dilation"] or cfg["dilation"] < 1:
        raise NotImplementedError(f"{name}: integer dilation >= 1 only")
    return (B, HD, T, F, H, W, W_t, nH, nW), (T_v,) + chunk


def _scalars(cfg, shape, frames):
    """The kernels' shared integer and float arguments, in their C order:
    the shapes, the video frames T_v and the chunk (t0, T_global, halo),
    then the search's."""
    B, HD, T, F, H, W, W_t, nH, nW = shape
    s1 = _stride1(cfg["stride1"], cfg["itype"])
    return (B, HD, T, F, H, W, nH, nW, W_t) + frames + (
        cfg["ws"], cfg["wt"], cfg["ps"], cfg["stride0"],
        int(cfg["dilation"]), s1, s1 * ((cfg["ws"] - 1) // 2),
        int(cfg["dist_type"] == "l2"), int(bool(cfg["full_ws"])),
        int(bool(cfg["use_adj"])), int(cfg["itype"] == "int"))


def nls_volume(vid0, vid1, ctr_h, ctr_w, *, ws, wt, ps, stride0, stride1,
               dist_type="l2", dilation=1, full_ws=True, use_adj=False,
               itype="float", query_t0=None, T_global=None):
    """B5, the search volume. vid0, vid1 [B,HD,T,F,H,W]; ctr_h, ctr_w
    [B,HD,T,W_t,nH,nW] reflected centres (ops/nls.search_centres; integers
    in the int path). Returns dists [B,HD,T,W_t,ws,ws,nH,nW]. Chunk mode:
    see the module's docstring."""
    cfg = dict(ws=ws, wt=wt, ps=ps, stride0=stride0, stride1=stride1,
               dist_type=dist_type, dilation=dilation, full_ws=full_ws,
               use_adj=use_adj, itype=itype, query_t0=query_t0,
               T_global=T_global)
    if vid0.device.type == "cpu":
        return nls_volume_plain(vid0, vid1, ctr_h, ctr_w, **cfg)
    shape, frames = _check("nls_volume", vid0, vid1, ctr_h, ctr_w, cfg)
    B, HD, T, F, H, W, W_t, nH, nW = shape
    vid0, vid1 = vid0.contiguous(), vid1.contiguous()
    ctr_h, ctr_w = ctr_h.contiguous(), ctr_w.contiguous()
    dists = torch.empty((B, HD, T, W_t, ws, ws, nH, nW), dtype=torch.float32,
                        device=vid0.device)
    lib = cuda_lib.load()
    with torch.cuda.device(vid0.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.stnls_nls_vol_fwd(
            vid0.data_ptr(), vid1.data_ptr(), ctr_h.data_ptr(),
            ctr_w.data_ptr(), dists.data_ptr(), *_scalars(cfg, shape, frames),
            int(COMPILED_BODY), stream)
    cuda_lib.check_launch(err, "nls_volume")
    nls_volume.launches += 1
    return dists


nls_volume.launches = 0


def nls_volume_bwd_plain(vid0, vid1, ctr_h, ctr_w, g_d, cfg):
    """Plain version of B6: the VJP of `nls_volume_plain`, recomputed under
    enable_grad one (batch, head) slice at a time, so that its autograd
    residuals (the corner reads of every tap, [.., W_t*ws*ws cells, nH,
    nW, F] each: ~17 GB a slice at 128^2, ws=5, W_t=5, F=8) stay inside a
    card's memory. Same arguments and outputs as `nls_volume_bwd`."""
    nls_volume_bwd_plain.calls += 1
    is_float = cfg["itype"] != "int"
    B, HD = vid0.shape[:2]
    vid0, vid1 = vid0.flatten(0, 1)[:, None], vid1.flatten(0, 1)[:, None]
    ctr_h, ctr_w = ctr_h.flatten(0, 1)[:, None], ctr_w.flatten(0, 1)[:, None]
    g_d = g_d.flatten(0, 1)[:, None]
    out = [[] for _ in range(4)]
    for s in range(B * HD):
        sl = slice(s, s + 1)
        with torch.enable_grad():
            inputs = [vid0[sl].detach().requires_grad_(),
                      vid1[sl].detach().requires_grad_(),
                      ctr_h[sl].detach().requires_grad_(is_float),
                      ctr_w[sl].detach().requires_grad_(is_float)]
            d = nls_volume_plain(*inputs, **cfg)
            wanted = [x for x in inputs if x.requires_grad]
            grads = iter(torch.autograd.grad(d, wanted, g_d[sl]))
        for acc, x in zip(out, inputs):
            acc.append(next(grads) if x.requires_grad else
                       torch.zeros_like(x))
    return tuple(torch.cat(acc).reshape((B, HD) + acc[0].shape[2:])
                 for acc in out)


nls_volume_bwd_plain.calls = 0


def nls_volume_bwd(vid0, vid1, ctr_h, ctr_w, g_d, cfg):
    """B6. vid0, vid1 [B,HD,T,F,H,W]; ctr_h, ctr_w [B,HD,T,W_t,nH,nW]; the
    cotangent g_d [B,HD,T,W_t,ws,ws,nH,nW]; cfg holds nls_volume's
    keywords. Returns (g_vid0, g_vid1, g_ctr_h, g_ctr_w); the centre
    gradients are 0 in the int path."""
    if vid0.device.type == "cpu":
        return nls_volume_bwd_plain(vid0, vid1, ctr_h, ctr_w, g_d, cfg)
    shape, frames = _check("nls_volume_bwd", vid0, vid1, ctr_h, ctr_w, cfg,
                           (("g_d", g_d),))
    B, HD, T, F, H, W, W_t, nH, nW = shape
    ws = cfg["ws"]
    if g_d.shape != (B, HD, T, W_t, ws, ws, nH, nW):
        raise ValueError("nls_volume_bwd: g_d [B,HD,T,W_t,ws,ws,nH,nW] "
                         "expected")
    vid0, vid1 = vid0.contiguous(), vid1.contiguous()
    ctr_h, ctr_w = ctr_h.contiguous(), ctr_w.contiguous()
    g_d = g_d.contiguous()
    g_vid0 = torch.zeros_like(vid0)
    g_vid1 = torch.zeros_like(vid1)
    g_ctr_h = torch.empty_like(ctr_h)
    g_ctr_w = torch.empty_like(ctr_w)
    lib = cuda_lib.load()
    with torch.cuda.device(vid0.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.stnls_nls_vol_bwd(
            vid0.data_ptr(), vid1.data_ptr(), ctr_h.data_ptr(),
            ctr_w.data_ptr(), g_d.data_ptr(), g_vid0.data_ptr(),
            g_vid1.data_ptr(), g_ctr_h.data_ptr(), g_ctr_w.data_ptr(),
            *_scalars(cfg, shape, frames), stream)
    cuda_lib.check_launch(err, "nls_volume_bwd")
    nls_volume_bwd.launches += 1
    return g_vid0, g_vid1, g_ctr_h, g_ctr_w


nls_volume_bwd.launches = 0


class _SearchVolume(torch.autograd.Function):
    """Forward: B5 (or its plain version on the CPU). Backward: B6."""

    @staticmethod
    def forward(ctx, vid0, vid1, ctr_h, ctr_w, cfg):
        ctx.save_for_backward(vid0, vid1, ctr_h, ctr_w)
        ctx.cfg = cfg
        return nls_volume(vid0, vid1, ctr_h, ctr_w, **cfg)

    @staticmethod
    def backward(ctx, g_d):
        vid0, vid1, ctr_h, ctr_w = ctx.saved_tensors
        grads = nls_volume_bwd(vid0, vid1, ctr_h, ctr_w, g_d, ctx.cfg)
        return grads + (None,)


def search_volume(vid0, vid1, ctr_h, ctr_w, *, ws, wt, ps, stride0,
                  stride1, dist_type="l2", dilation=1, full_ws=True,
                  use_adj=False, itype="float", query_t0=None,
                  T_global=None):
    """The search volume dists [B,HD,T,W_t,ws,ws,nH,nW] at the centres
    ctr_h, ctr_w [B,HD,T,W_t,nH,nW] (ops/nls.search_centres),
    differentiable in vid0, vid1 and the centres through B6 (in chunk
    mode with query_t0, T_global)."""
    cfg = dict(ws=ws, wt=wt, ps=ps, stride0=stride0, stride1=stride1,
               dist_type=dist_type, dilation=dilation, full_ws=full_ws,
               use_adj=use_adj, itype=itype, query_t0=query_t0,
               T_global=T_global)
    return _SearchVolume.apply(vid0, vid1, ctr_h, ctr_w, cfg)
