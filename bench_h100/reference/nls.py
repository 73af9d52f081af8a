"""The flow-guided non-local search and the patch gather in plain
PyTorch, at stride0 = stride1 = 1, dilation 1, "l2" distances, float
offsets, reflected bounds, a window kept inside the frame (full_ws) and
the query itself anchored in slot 0: the semantics of stnls (Gauen & Chan,
arXiv:2309.16849) as the JAX package defines them.

  * search_flow: the per-frame flows fflow/bflow walked into the offsets
    from each query frame to the other frames of its time window, each
    step a bilinear read of the next flow at the walk's position (corners
    read at reflected coordinates);
  * centres: the query pixel plus its slot's offset, reflected once into
    the frame; the ws x ws window around it, shifted to stay inside;
  * patch distance: the sum over the ps x ps taps and the channels of
    (q[tap] - k[bilinear at position + tap])^2, a tap position reflected
    once, a bilinear corner outside the frame weighted 0;
  * selection: slot 0 holds the cell nearest the query (the first argmin
    of |dt| + |dh| + |dw|), then the K - 1 smallest distances of the
    other cells, in ascending order;
  * gather: for each slot, every query's ps x ps patch read bilinearly at
    its key position (corners from the frame padded by reflection),
    weighted and added back at the query's own patch pixels, divided by
    how many patches cover each pixel.

Everything is computed per head and in blocks of query frames so that
1080p fits; the order of the sums is the plain one: taps row by row,
channels one after another, bilinear corners (0,0), (0,1), (1,0), (1,1).
"""

import torch


def reflect(x, L):
    """One reflection at the borders: -1 -> 1, L -> L - 2."""
    x = torch.where(x < 0, -x, x)
    return torch.where(x > L - 1, 2 * (L - 1) - x, x)


def inside(x, L):
    return (x >= 0) & (x <= L - 1)


def window_frames(T, wt):
    """[T][W_t] the frames of each query frame's window: forward from the
    query to the window's last frame, then backward from the query."""
    W_t = min(2 * wt + 1, T)
    table = []
    for ti in range(T):
        shift = min(0, ti - wt) + max(0, ti + wt - (T - 1))
        t_max = min(T - 1, ti + wt - shift)
        table.append([ti + s if ti + s <= t_max else t_max - s
                      for s in range(W_t)])
    return table


def _sample_flow(flow, h, w):
    """Bilinear read of flow [T',2,H,W] (one frame per row of h, w
    [T',H,W]) with corners at reflected coordinates -> (dW, dH)."""
    Tn, _, H, W = flow.shape
    h0, w0 = torch.floor(h), torch.floor(w)
    fh, fw = h - h0, w - w0
    h0, w0 = h0.long(), w0.long()
    planes = flow.reshape(Tn, 2, H * W)
    out_w, out_h = 0., 0.
    for di in (0, 1):
        hr = reflect(h0 + di, H).clamp(0, H - 1)
        wh = torch.clamp(1. - torch.abs(di - fh), min=0.)
        for dj in (0, 1):
            wr = reflect(w0 + dj, W).clamp(0, W - 1)
            wgt = wh * torch.clamp(1. - torch.abs(dj - fw), min=0.)
            idx = (hr * W + wr).reshape(Tn, 1, H * W).expand(Tn, 2, H * W)
            val = torch.gather(planes, 2, idx).reshape(Tn, 2, H, W)
            out_w = out_w + wgt * val[:, 0]
            out_h = out_h + wgt * val[:, 1]
    return out_w, out_h


def search_flow(fflow, bflow, wt):
    """fflow/bflow [T,2,H,W] (one clip) -> (off_h, off_w) [T,W_t,H,W],
    the offset from each query pixel to its walk's position in each frame
    of its window (slot 0, the query frame, 0)."""
    T, _, H, W = fflow.shape
    W_t = min(2 * wt + 1, T)
    dev = fflow.device
    hh = torch.arange(H, device=dev, dtype=fflow.dtype)[:, None] \
        .expand(T, H, W)
    ww = torch.arange(W, device=dev, dtype=fflow.dtype)[None, :] \
        .expand(T, H, W)
    out_h = [torch.zeros_like(hh)]
    out_w = [torch.zeros_like(ww)]
    cur_h, cur_w = hh, ww
    table = window_frames(T, wt)
    for si in range(1, W_t):
        restart, picks = [], []
        for ti in range(T):
            shift = min(0, ti - wt) + max(0, ti + wt - (T - 1))
            t_max = min(T - 1, ti + wt - shift)
            tj = table[ti][si]
            restart.append(ti + si - 1 == t_max)
            picks.append((fflow, tj - 1) if tj > ti else (bflow, tj + 1))
        r = torch.tensor(restart, device=dev)[:, None, None]
        cur_h = torch.where(r, hh, cur_h)
        cur_w = torch.where(r, ww, cur_w)
        flow = torch.stack([src[t] for src, t in picks])
        d_w, d_h = _sample_flow(flow, cur_h, cur_w)
        cur_h, cur_w = cur_h + d_h, cur_w + d_w
        out_h.append(cur_h - hh)
        out_w.append(cur_w - ww)
    return torch.stack(out_h, 1), torch.stack(out_w, 1)


def window_offset(ctr, ws, L):
    """How many lattice points lie before the centres `ctr` (float) in
    their window of ws, shifted so that all ws lie inside [0, L - 1];
    cell i lies at ctr + (i - offset)."""
    half = (ws - 1) // 2
    off = torch.full_like(ctr, float(half))
    off = torch.where(ctr - half < 0, torch.floor(ctr), off)
    last = ctr + ((ws - 1) - off)
    off = torch.where(last > L - 1, torch.ceil(ctr - (L - 1) + (ws - 1)),
                      off)
    return torch.round(off)


class Geometry:
    """The search geometry of one clip: for query frame t and window slot
    st, the key frame tj(t, st), the window's centre (ctr_h, ctr_w) and
    offset (off_h, off_w) [T,W_t,H,W]; cell (st, i, j) lies at
    (ctr_h + (i - off_h), ctr_w + (j - off_w))."""

    def __init__(self, fflow, bflow, ws, wt):
        T, _, H, W = fflow.shape
        self.T, self.H, self.W, self.ws, self.wt = T, H, W, ws, wt
        self.W_t = min(2 * wt + 1, T)
        self.frames = window_frames(T, wt)
        dev = fflow.device
        with torch.no_grad():
            off_h, off_w = search_flow(fflow, bflow, wt)
            hh = torch.arange(H, device=dev, dtype=fflow.dtype)[:, None]
            ww = torch.arange(W, device=dev, dtype=fflow.dtype)[None, :]
            self.ctr_h = reflect(hh + off_h, H)
            self.ctr_w = reflect(ww + off_w, W)
            self.off_h = window_offset(self.ctr_h, ws, H)
            self.off_w = window_offset(self.ctr_w, ws, W)


def rows(v):
    """[T,F,H,W] -> pixel rows [T*H*W, F]."""
    T, F, H, W = v.shape
    return v.permute(0, 2, 3, 1).reshape(T * H * W, F)


def patch_dists(r0, r1, shape, t, h, w, tj, ph, pw, ps):
    """Patch distances between queries (t, h, w) (long, broadcastable)
    of the rows r0 and key positions (tj long; ph, pw float) of the rows
    r1, video shape (T, F, H, W): the sum over taps and channels of the
    squared differences, a tap outside the frame (after one reflection)
    adding 0. Differentiable in r0 and r1."""
    _, F, H, W = shape
    acc = 0.
    for pi in range(ps):
        d_h = pi - ps // 2
        rh = reflect(h + d_h, H)
        qh = reflect(ph + d_h, H)
        for pj in range(ps):
            d_w = pj - ps // 2
            rw = reflect(w + d_w, W)
            qw = reflect(pw + d_w, W)
            p0 = r0[(t * H + rh) * W + rw]
            h0, w0 = torch.floor(qh), torch.floor(qw)
            p1 = 0.
            for di in (0, 1):
                for dj in (0, 1):
                    hc, wc = h0 + di, w0 + dj
                    wgt = (torch.clamp(1. - torch.abs(hc - qh), min=0.)
                           * torch.clamp(1. - torch.abs(wc - qw), min=0.))
                    wgt = torch.where(inside(hc, H) & inside(wc, W), wgt,
                                      torch.zeros_like(wgt))
                    ci = (tj * H + hc.clamp(0, H - 1).long()) * W \
                        + wc.clamp(0, W - 1).long()
                    p1 = p1 + wgt[..., None].to(r1.dtype) * r1[ci]
            diff = p0 - p1
            sq = diff * diff
            s = sq[..., 0]
            for f in range(1, F):
                s = s + sq[..., f]
            ok = inside(qh, H) & inside(qw, W) & inside(rh, H) \
                & inside(rw, W)
            acc = acc + torch.where(ok, s, torch.zeros_like(s))
    return acc


def select(q, k, geo, ps, K, t):
    """The anchored top-K of query frame t of one head: q, k [T,F,H,W].
    Returns (dists [H,W,K], offsets [H,W,K,3] as (dt, dh, dw)), without
    gradient; the distances of every window cell computed one cell at a
    time."""
    T, F, H, W = q.shape
    dev = q.device
    r0, r1 = rows(q), rows(k)
    hh = torch.arange(H, device=dev)[:, None]
    ww = torch.arange(W, device=dev)[None, :]
    ws = geo.ws
    dists, near, near_id = [], None, None
    with torch.no_grad():
        for st in range(geo.W_t):
            tj = geo.frames[t][st]
            ch, cw = geo.ctr_h[t, st], geo.ctr_w[t, st]
            oh, ow = geo.off_h[t, st], geo.off_w[t, st]
            for i in range(ws):
                for j in range(ws):
                    ph, pw = ch + (i - oh), cw + (j - ow)
                    d = patch_dists(r0, r1, q.shape, t, hh, ww, tj, ph, pw,
                                    ps)
                    ok = inside(ph, H) & inside(pw, W)
                    dists.append(torch.where(ok, d,
                                             torch.full_like(d, float("inf"))))
                    l1 = abs(tj - t) + (ph - hh).abs() + (pw - ww).abs()
                    cid = len(dists) - 1
                    if near is None:
                        near = l1
                        near_id = torch.zeros_like(hh * ww)
                    else:
                        closer = l1 < near
                        near = torch.where(closer, l1, near)
                        near_id = torch.where(closer, cid, near_id)
        vol = torch.stack(dists, -1)                      # [H,W,S]
        d_self = torch.gather(vol, -1, near_id[..., None])
        rest = vol.scatter(-1, near_id[..., None], float("inf"))
        d_rest, c_rest = torch.topk(rest, K - 1, dim=-1, largest=False,
                                    sorted=True)
        cells = torch.cat([near_id[..., None], c_rest], -1)
        st = cells // (ws * ws)
        i = (cells // ws) % ws
        j = cells % ws
        tj = torch.tensor(geo.frames[t], device=dev)[st]
        ph = torch.gather(geo.ctr_h[t].permute(1, 2, 0), -1, st) \
            + (i - torch.gather(geo.off_h[t].permute(1, 2, 0), -1, st))
        pw = torch.gather(geo.ctr_w[t].permute(1, 2, 0), -1, st) \
            + (j - torch.gather(geo.off_w[t].permute(1, 2, 0), -1, st))
        offs = torch.stack([(tj - t).to(ph.dtype), ph - hh[..., None],
                            pw - ww[..., None]], -1)
        offs[..., 0, :] = 0.
    return torch.cat([d_self, d_rest], -1), offs


def key_positions(offs, t, H, W):
    """Key frame and position of offsets [...,H,W,K,3] (dt, dh, dw) from
    the queries of frame t: (tj long, ph, pw), as the search reads them."""
    dev = offs.device
    hh = torch.arange(H, device=dev)[:, None, None]
    ww = torch.arange(W, device=dev)[None, :, None]
    tj = (t + torch.round(offs[..., 0])).long()
    return tj, hh + offs[..., 1], ww + offs[..., 2]


def dists_at(q, k, offs, ps, t):
    """Patch distances [H,W,K] of the queries of frame t at offsets
    [H,W,K,3]: differentiable in q and k [T,F,H,W]."""
    T, F, H, W = q.shape
    dev = q.device
    tj, ph, pw = key_positions(offs, t, H, W)
    hh = torch.arange(H, device=dev)[:, None, None]
    ww = torch.arange(W, device=dev)[None, :, None]
    return patch_dists(rows(q), rows(k), q.shape, t, hh, ww, tj, ph, pw,
                       ps)


def overlap_counts(H, W, ps, device):
    """How many query patches cover each pixel, [H,W]."""
    def one(L):
        c = torch.zeros(L, device=device)
        for p in range(ps):
            d = p - ps // 2
            lo, hi = max(0, -d), min(L, L - d)
            c[lo + d:hi + d] += 1
        return c
    return one(H)[:, None] * one(W)[None, :]


def gather_slot(v, w_k, offs_k, ps):
    """The stack of one slot for one head: v [T,F,H,W], weights w_k
    [T,H,W], offsets offs_k [T,H,W,3] -> [T,F,H,W], the sum over taps of
    each query's weighted patch added at its own patch pixels, not yet
    divided by the overlap counts. Differentiable in v and w_k."""
    T, F, H, W = v.shape
    dev = v.device
    pad = ps + 1
    vp = torch.nn.functional.pad(v, (pad, pad, pad, pad), mode="reflect")
    Hp, Wp = H + 2 * pad, W + 2 * pad
    rp = vp.permute(0, 2, 3, 1).reshape(T * Hp * Wp, F)
    tt = torch.arange(T, device=dev)[:, None, None]
    hh = torch.arange(H, device=dev)[None, :, None]
    ww = torch.arange(W, device=dev)[None, None, :]
    nl_t = reflect(tt + torch.round(offs_k[..., 0]).long(), T).clamp(0, T - 1)
    o_h = reflect(hh + offs_k[..., 1], H) - ps // 2
    o_w = reflect(ww + offs_k[..., 2], W) - ps // 2
    fi, fj = torch.floor(o_h), torch.floor(o_w)
    fh, fw = o_h - fi, o_w - fj
    fi, fj = fi.long() + pad, fj.long() + pad
    wh, wv = (1. - fh, fh), (1. - fw, fw)
    out = v.new_zeros((T, F, H, W))
    for pi in range(ps):
        d_h = pi - ps // 2
        h0, h1 = max(0, -d_h), min(H, H - d_h)
        for pj in range(ps):
            d_w = pj - ps // 2
            w0, w1 = max(0, -d_w), min(W, W - d_w)
            pv = 0.
            for u in (0, 1):
                for c in (0, 1):
                    idx = ((nl_t * Hp + fi + pi + u) * Wp + fj + pj + c)
                    pv = pv + (wh[u] * wv[c])[..., None] * rp[idx]
            val = (pv * w_k[..., None]).permute(0, 3, 1, 2)   # [T,F,H,W]
            out = _add_at(out, val, h0, h1, w0, w1, d_h, d_w)
    return out


def _add_at(out, val, h0, h1, w0, w1, d_h, d_w):
    """out with val's queries [h0:h1, w0:w1] added at their pixels shifted
    by (d_h, d_w), out of place (autograd-safe)."""
    pad = (w0 + d_w, out.shape[-1] - (w1 + d_w),
           h0 + d_h, out.shape[-2] - (h1 + d_h))
    return out + torch.nn.functional.pad(val[..., h0:h1, w0:w1], pad)
