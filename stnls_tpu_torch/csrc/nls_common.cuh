// Geometry and patch-distance code shared by the search kernels B1
// (nls_topk_fwd.cu), B5 (nls_vol_fwd.cu) and B6 (nls_vol_bwd.cu), so that
// the three read the same lattice the same way (B5 and B6 take the
// geometry; patch_dist and the query forms are B1's).
//
// Temporal chunks (time sharding): B1, B2, B5 and B6 take the query
// frames of one chunk of a sequence of Tg frames, t0 the global index of
// its first query frame, from videos of Tv frames that hold the chunk
// plus `halo` frames on each side (chunk_window_frame). A call on the
// whole video is the chunk (t0, Tg, halo) = (0, T, 0) with Tv = T.
//
// The functions over an argument struct `A` read these fields of it: H, W,
// ws, stride1 (float; the int path passes max(1, int(stride1))), s1_half
// (stride1 * ((ws-1)/2), rounded once on the host, as the reference
// computes it), full_ws, dilation, use_adj, is_int and l2; the run-time
// query form (GlobalQuery) also ps and F (the channels a head).
//
// The float path follows stnls_tpu_torch/ops/geometry.py and
// ops/nls.lattice_search. The _rn intrinsics keep nvcc from contracting
// the geometry and the distance sums into FMAs, and the sums run in
// lattice_search's order (corners, then channels, then taps, one rounded
// add at a time), so the lattice and the distances are bitwise the plain
// version's: softmax(-10 d) at |d| ~ 256 turns a one-ulp difference of d
// into a 1e-3 change of a weight's share, which two routes with other
// roundings could not be compared through.

#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int reflect_i(int v, int lim) {
  int out = v < 0 ? -v : v;
  return v > lim - 1 ? 2 * (lim - 1) - v : out;
}

__device__ __forceinline__ float reflect_f(float v, int lim) {
  float out = v < 0.f ? -v : v;
  return v > (float)(lim - 1) ? __fsub_rn((float)(2 * (lim - 1)), v) : out;
}

// d reflect_f(v) / dv: -1 where the reflection flips the coordinate
__device__ __forceinline__ float reflect_sign(float v, int lim) {
  return (v < 0.f || v > (float)(lim - 1)) ? -1.f : 1.f;
}

__device__ __forceinline__ bool inb_f(float v, int lim) {
  return v >= 0.f && v <= (float)(lim - 1);
}

// Target frame of time slot st for query frame t: the boundary-shifted
// window of geometry.time_window_frames.
__device__ __forceinline__ int window_frame(int t, int st, int wt, int T) {
  const int t_shift = min(0, t - wt) + max(0, t + wt - (T - 1));
  const int t_max = min(T - 1, t + wt - t_shift);
  return (t + st <= t_max) ? t + st : t_max - st;
}

// Target frame of time slot st for query frame t of a chunk, as an index
// into the chunk's videos: the window of global frame t0 + t in a sequence
// of Tg frames, shifted by the frames before the chunk's videos. With
// halo >= 2*wt it lies inside them; the query itself is frame t + halo.
__device__ __forceinline__ int chunk_window_frame(int t, int st, int wt, int t0,
                                                  int Tg, int halo) {
  return window_frame(t0 + t, st, wt, Tg) - t0 + halo;
}

// Window offset of one axis (geometry.search_offsets), float path.
template <class A>
__device__ float ws_offset_f(float xi, const A& a, int L) {
  float off = (float)((a.ws - 1) / 2);
  if (!a.full_ws) return off;
  const float s1 = a.stride1;
  float off_min = floorf(__fdiv_rn(xi, s1));
  if (__fsub_rn(xi, a.s1_half) < 0.f) off = off_min;
  float x_max = __fadd_rn(xi, __fmul_rn(s1, __fsub_rn((float)(a.ws - 1), off)));
  float off_max = ceilf(__fadd_rn(__fdiv_rn(__fsub_rn(xi, (float)(L - 1)), s1),
                                  (float)(a.ws - 1)));
  if (x_max > (float)(L - 1)) off = off_max;
  return rintf(off);
}

// Int path: integer centre, integer stride.
template <class A>
__device__ int ws_offset_i(int xi, const A& a, int L) {
  const int wsHalf = (a.ws - 1) / 2;
  int off = wsHalf;
  if (!a.full_ws) return off;
  const int s1 = (int)a.stride1;
  int off_min = (int)floorf(__fdiv_rn((float)xi, (float)s1));
  if (xi - s1 * wsHalf < 0) off = off_min;
  int x_max = xi + s1 * ((a.ws - 1) - off);
  int off_max = (int)ceilf(__fadd_rn(__fdiv_rn((float)(xi - (L - 1)), (float)s1),
                                     (float)(a.ws - 1)));
  if (x_max > L - 1) off = off_max;
  return off;
}

// Window offsets (oh, ow) of a reflected search centre (ch, cw); int-path
// values are integers held exactly in floats.
template <class A>
__device__ __forceinline__ void window_offsets(const A& a, float ch, float cw,
                                               float* oh, float* ow) {
  if (a.is_int) {
    *oh = (float)ws_offset_i((int)ch, a, a.H);
    *ow = (float)ws_offset_i((int)cw, a, a.W);
  } else {
    *oh = ws_offset_f(ch, a, a.H);
    *ow = ws_offset_f(cw, a, a.W);
  }
}

__device__ __forceinline__ float lattice(float ctr, float off, float s1, int i) {
  return __fadd_rn(ctr, __fmul_rn(s1, __fsub_rn((float)i, off)));
}

// The query patch of vid0 (one frame, [F,H,W]) at query pixel (ref_h,
// ref_w), in one of two forms with one interface, so that patch_dist sums
// in the same order for both:
//   RegQuery<PS, FC>: ps and F known at compile time; the patch is loaded
//     once into registers, v[tap * FC + f], and reused across the cells;
//   GlobalQuery: ps and F known at run time; a tap's channels are read
//     from vid0 at each use, through the read-only data cache (__ldg). The
//     patch would not fit a thread's registers (ps=7, F=32: 1,568 floats),
//     and a warp's neighbouring queries read neighbouring pixels of the
//     same rows, which stay in L1 across the cells.
// Interface: ps() and nf(); tap(a, pi, pj, &h) says whether the tap's
// reflected pixel lies in the frame and sets the handle h through which
// val(h, f, HW) reads its channel f, HW = H * W apart (nothing is read for
// a tap outside).
template <int PS, int FC>
struct RegQuery {
  using Tap = int;
  float v[PS * PS * FC];
  bool ok[PS * PS];

  template <class A>
  __device__ __forceinline__ void load(const A& a, const float* v0, int ref_h,
                                       int ref_w) {
    const int H = a.H, W = a.W;
    const long long HW = (long long)H * W;
    const int po = a.use_adj ? 0 : -(PS / 2);
#pragma unroll
    for (int pi = 0; pi < PS; ++pi) {
#pragma unroll
      for (int pj = 0; pj < PS; ++pj) {
        const int rh = reflect_i(ref_h + a.dilation * (pi + po), H);
        const int rw = reflect_i(ref_w + a.dilation * (pj + po), W);
        ok[pi * PS + pj] = rh >= 0 && rh < H && rw >= 0 && rw < W;
        const int o = min(max(rh, 0), H - 1) * W + min(max(rw, 0), W - 1);
#pragma unroll
        for (int f = 0; f < FC; ++f) v[(pi * PS + pj) * FC + f] = v0[f * HW + o];
      }
    }
  }
  __device__ __forceinline__ int ps() const { return PS; }
  __device__ __forceinline__ int nf() const { return FC; }
  template <class A>
  __device__ __forceinline__ bool tap(const A&, int pi, int pj, Tap* h) const {
    *h = (pi * PS + pj) * FC;
    return ok[pi * PS + pj];
  }
  __device__ __forceinline__ float val(Tap h, int f, long long) const {
    return v[h + f];
  }
};

struct GlobalQuery {
  using Tap = const float*;
  const float* v0;
  int ref_h, ref_w, ps_, nf_, po;

  template <class A>
  __device__ __forceinline__ void load(const A& a, const float* v0_, int rh,
                                       int rw) {
    v0 = v0_;
    ref_h = rh;
    ref_w = rw;
    ps_ = a.ps;
    nf_ = a.F;
    po = a.use_adj ? 0 : -(a.ps / 2);
  }
  __device__ __forceinline__ int ps() const { return ps_; }
  __device__ __forceinline__ int nf() const { return nf_; }
  template <class A>
  __device__ __forceinline__ bool tap(const A& a, int pi, int pj, Tap* h) const {
    const int rh = reflect_i(ref_h + a.dilation * (pi + po), a.H);
    const int rw = reflect_i(ref_w + a.dilation * (pj + po), a.W);
    *h = v0 + (long long)rh * a.W + rw;
    return rh >= 0 && rh < a.H && rw >= 0 && rw < a.W;
  }
  __device__ __forceinline__ float val(Tap h, int f, long long HW) const {
    return __ldg(h + f * HW);
  }
};

// The query form of a kernel instantiated for (PS, FC); FC = 0 takes F
// (and ps) from the arguments at run time.
template <int PS, int FC>
struct QueryOf {
  using type = RegQuery<PS, FC>;
};
template <int PS>
struct QueryOf<PS, 0> {
  using type = GlobalQuery;
};

// The two bilinear corners of a float key coordinate p inside [0, L-1] on
// one axis: the integer pixels i0 and i1 = i0 + 1 (i0 itself, weighted 0,
// where i0 is the last pixel: ok1 false) and their weights.
struct AxisCorner {
  int i0, i1;
  float w0, w1;
  bool ok1;
};

__device__ __forceinline__ AxisCorner axis_corner(float p, int L) {
  AxisCorner c;
  const float f0 = floorf(p);
  c.w0 = fmaxf(0.f, 1.f - fabsf(f0 - p));
  c.w1 = fmaxf(0.f, 1.f - fabsf(__fadd_rn(f0, 1.f) - p));
  c.i0 = (int)f0;
  c.ok1 = c.i0 + 1 <= L - 1;
  c.i1 = c.ok1 ? c.i0 + 1 : c.i0;
  return c;
}

// Bilinear corners of a float key position (ph, pw) inside the frame:
// offsets into one channel plane and weights, with a corner beyond the
// last row or column weighted 0 (its offset clamped), as lattice_search
// reads them.
struct Corners {
  int o00, o01, o10, o11;
  float wh0, wh1, ww0, ww1;   // the axis weights
  bool okh1, okw1;            // the second row / column lies in the frame
};

__device__ __forceinline__ Corners corners(float ph, float pw, int H, int W) {
  const AxisCorner h = axis_corner(ph, H), w = axis_corner(pw, W);
  Corners c;
  c.wh0 = h.w0;
  c.wh1 = h.w1;
  c.ww0 = w.w0;
  c.ww1 = w.w1;
  c.okh1 = h.ok1;
  c.okw1 = w.ok1;
  c.o00 = h.i0 * W + w.i0;
  c.o01 = h.i0 * W + w.i1;
  c.o10 = h.i1 * W + w.i0;
  c.o11 = h.i1 * W + w.i1;
  return c;
}

// Patch distance between the query patch qp (RegQuery or GlobalQuery) and
// the key patch of vid1 (one frame, [F,H,W]) whose first tap is at lattice
// position (ph0, pw0): the taps are reflected, and read bilinearly (float)
// or at one pixel (int). Taps in order, channels inner, one rounded add at
// a time, whichever the query's form.
template <class A, class Q>
__device__ __forceinline__ float patch_dist(const A& a, const float* v1,
                                            const Q& qp, float ph0, float pw0) {
  const int H = a.H, W = a.W;
  const long long HW = (long long)H * W;
  const int ps = qp.ps(), nf = qp.nf();
  const int po = a.use_adj ? 0 : -(ps / 2);
  float acc = 0.f;
#pragma unroll
  for (int pi = 0; pi < ps; ++pi) {
    const float ph = reflect_f(__fadd_rn(ph0, (float)(a.dilation * (pi + po))), H);
    const bool okh = inb_f(ph, H);
#pragma unroll
    for (int pj = 0; pj < ps; ++pj) {
      const float pw = reflect_f(__fadd_rn(pw0, (float)(a.dilation * (pj + po))), W);
      typename Q::Tap h;
      if (!(qp.tap(a, pi, pj, &h) && okh && inb_f(pw, W))) continue;
      float s = 0.f;
      if (a.is_int) {
        const float* p = v1 + (int)ph * W + (int)pw;
#pragma unroll
        for (int f = 0; f < nf; ++f) {
          const float p1 = p[f * HW];
          const float q = qp.val(h, f, HW);
          const float df = q - p1;
          s = __fadd_rn(s, a.l2 ? __fmul_rn(df, df) : __fmul_rn(q, p1));
        }
      } else {
        const Corners c = corners(ph, pw, H, W);
        const float w00 = c.wh0 * c.ww0;
        const float w01 = c.okw1 ? c.wh0 * c.ww1 : 0.f;
        const float w10 = c.okh1 ? c.wh1 * c.ww0 : 0.f;
        const float w11 = (c.okh1 && c.okw1) ? c.wh1 * c.ww1 : 0.f;
#pragma unroll
        for (int f = 0; f < nf; ++f) {
          const float* p = v1 + f * HW;
          float p1 = __fmul_rn(w00, p[c.o00]);
          p1 = __fadd_rn(p1, __fmul_rn(w01, p[c.o01]));
          p1 = __fadd_rn(p1, __fmul_rn(w10, p[c.o10]));
          p1 = __fadd_rn(p1, __fmul_rn(w11, p[c.o11]));
          const float q = qp.val(h, f, HW);
          const float df = q - p1;
          s = __fadd_rn(s, a.l2 ? __fmul_rn(df, df) : __fmul_rn(q, p1));
        }
      }
      acc = __fadd_rn(acc, s);
    }
  }
  return acc;
}

}  // namespace
