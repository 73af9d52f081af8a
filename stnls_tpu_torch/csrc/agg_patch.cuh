// The scatter of a query's local patch into its non-local patches, shared
// by B7 (agg_scatter_add_fwd.cu: the video at the query's taps, into the
// output) and B10 (agg_pool_bwd.cu: the query's block of the cotangent,
// into the video gradient). Both kernels run one thread per (query,
// vector of VW channels), a query's ng lanes side by side in a warp
// (cuda_lib.channel_layout), walking the query's K slots; for each live
// slot a lane adds w * its patch into the ps x ps patch around the slot's
// centre, VW channels at a time, into a channels-last accumulator
// (add_channels).

#pragma once

#include "agg_common.cuh"
#include "vec_ops.cuh"

namespace {

// The local patch of one query: the VW channels from c0 (the nc < VW
// that exist; the rest read as 0) of the ps x ps pixels (r0 + step * pi,
// w0 + step * pj) of one planar frame [F, Lh, Lw], `frame` pointing at
// channel c0; a pixel outside the frame is no tap. With PS > 0 (ps
// compiled in) it is held in registers, read once; LocalPatch<0, VW>
// reads it from global memory at each use, through the read-only path.
// Interface: in(pi, pj), whether the tap exists; get(x, pi, pj), its
// channels.
template <int PS, int VW>
struct LocalPatch {
  float v[PS * PS][VW];
  bool ok[PS * PS];

  __device__ __forceinline__ LocalPatch(const float* frame, long long HW, int Lh, int Lw,
                                        int r0, int w0, int step, int nc) {
#pragma unroll
    for (int pi = 0; pi < PS; ++pi) {
#pragma unroll
      for (int pj = 0; pj < PS; ++pj) {
        const int r = r0 + step * pi, w = w0 + step * pj, u = pi * PS + pj;
        ok[u] = inb(r, Lh) && inb(w, Lw);
        load_channels<VW, false>(v[u], frame + (ok[u] ? (long long)r * Lw + w : 0), HW,
                                 ok[u] ? nc : 0);
      }
    }
  }
  __device__ __forceinline__ bool in(int pi, int pj) const { return ok[pi * PS + pj]; }
  __device__ __forceinline__ void get(float (&x)[VW], int pi, int pj) const {
#pragma unroll
    for (int c = 0; c < VW; ++c) x[c] = v[pi * PS + pj][c];
  }
};

template <int VW>
struct LocalPatch<0, VW> {
  const float* frame;
  long long HW;
  int Lh, Lw, r0, w0, step, nc;

  __device__ __forceinline__ LocalPatch(const float* frame_, long long HW_, int Lh_, int Lw_,
                                        int r0_, int w0_, int step_, int nc_)
      : frame(frame_), HW(HW_), Lh(Lh_), Lw(Lw_), r0(r0_), w0(w0_), step(step_), nc(nc_) {}
  __device__ __forceinline__ bool in(int pi, int pj) const {
    return inb(r0 + step * pi, Lh) && inb(w0 + step * pj, Lw);
  }
  __device__ __forceinline__ void get(float (&x)[VW], int pi, int pj) const {
    load_channels<VW, false>(x, frame + (long long)(r0 + step * pi) * Lw + w0 + step * pj,
                             HW, nc);
  }
};

// Visits each tap (pi, pj) of a ps x ps patch (ps = PS when compiled in)
// whose pixel, the non-local centre (ch, cw) plus d = dilation * (p +
// po), reflected once when `reflect`, lies in an Lh x Lw frame:
// visit(pi, pj, the pixel's index sh * Lw + sw).
template <int PS, class Visit>
__device__ __forceinline__ void walk_taps(int ps_rt, int dilation, int po, int ch, int cw,
                                          int Lh, int Lw, int reflect, Visit&& visit) {
  const int ps = PS > 0 ? PS : ps_rt;
#pragma unroll
  for (int pi = 0; pi < ps; ++pi) {
    const int sh = tap_pos(ch, dilation * (pi + po), Lh, reflect);
    if (sh < 0) continue;
#pragma unroll
    for (int pj = 0; pj < ps; ++pj) {
      const int sw = tap_pos(cw, dilation * (pj + po), Lw, reflect);
      if (sw >= 0) visit(pi, pj, sh * Lw + sw);
    }
  }
}

// w * x (VW channels from c0, a multiple of VW) added into pixel `pix` of
// one frame of a channels-last accumulator, Fp channels a pixel: one
// float2/float4 atomic
template <int VW>
__device__ __forceinline__ void add_channels(float* frame, int pix, int Fp, int c0, float w,
                                             const float (&x)[VW]) {
  float y[VW];
#pragma unroll
  for (int c = 0; c < VW; ++c) y[c] = w * x[c];
  vatomic<VW>(frame + (long long)pix * Fp + c0, y);
}

// The lanes of the calling thread's query in its warp: ng (a power of two
// up to 32) neighbouring lanes, aligned to ng
__device__ __forceinline__ unsigned query_lanes(int ng) {
  const unsigned lane = threadIdx.x & 31u;
  return ng == 32 ? 0xffffffffu : ((1u << ng) - 1u) << (lane & ~(unsigned)(ng - 1));
}

}  // namespace
