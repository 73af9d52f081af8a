// Index arithmetic shared by the ScatterAdd kernels (B7
// agg_scatter_add_fwd.cu, B8 agg_scatter_add_bwd.cu) and the
// PooledPatchSum kernels (B9 agg_pool_fwd.cu, B10 agg_pool_bwd.cu), so
// that a forward and its backward read and write the same pixels, and
// the centre table and channel loads of B8 and B9.
//
// Both ops take integer offsets: the float offsets are rounded half to
// even (rintf, as torch.round and jnp.round; roundf would round half away
// from zero). An entry whose rounded offset reaches 1e7 in any component
// is the search's -1e8 "invalid" fill and is skipped. Reflection is the
// reference's single fold, unclamped, followed by an explicit in-frame
// test (stnls_tpu_torch/ops/geometry.reflect_bounds, in_bounds).

#pragma once

#include <cuda_runtime.h>

namespace {

// single reflection at the border: -1 -> 1, lim -> lim - 2
__device__ __forceinline__ int reflect1(int v, int lim) {
  return v < 0 ? -v : (v > lim - 1 ? 2 * (lim - 1) - v : v);
}

__device__ __forceinline__ bool inb(int v, int lim) { return v >= 0 && v < lim; }

// The rounded offsets (dt, dh, dw) of one (query, slot); false for a fill.
__device__ __forceinline__ bool int_offsets(const float* fl, int* dt, int* dh, int* dw) {
  const float t = rintf(fl[0]), h = rintf(fl[1]), w = rintf(fl[2]);
  if (!(fabsf(t) < 1e7f && fabsf(h) < 1e7f && fabsf(w) < 1e7f)) return false;
  *dt = (int)t;
  *dh = (int)h;
  *dw = (int)w;
  return true;
}

// The non-local centre of query (t, qh, qw) on a grid of stride `stride`
// over an L_h x L_w frame: each coordinate plus its offset, reflected once
// (ops/agg._km_centers, int path). False for a fill.
__device__ __forceinline__ bool nl_centre(const float* fl, int t, int qh, int qw,
                                          int stride, int T, int Lh, int Lw,
                                          int* nl_t, int* nl_h, int* nl_w) {
  int dt, dh, dw;
  if (!int_offsets(fl, &dt, &dh, &dw)) return false;
  *nl_t = reflect1(t + dt, T);
  *nl_h = reflect1(qh * stride + dh, Lh);
  *nl_w = reflect1(qw * stride + dw, Lw);
  return true;
}

// A tap at centre c plus d along an axis of length L: reflected once when
// `reflect`, then -1 if it lies outside.
__device__ __forceinline__ int tap_pos(int c, int d, int L, int reflect) {
  int s = c + d;
  if (reflect) s = reflect1(s, L);
  return inb(s, L) ? s : -1;
}

// The centre tables of B8 and B9: a block resolves the centre of every
// (query, slot) its threads read once, into shared memory, one int4 an
// entry: the weight's bits (x) and the centre (y, z, w = nl_t, nl_h,
// nl_w), read back with one 16-byte load. A -1e8 fill gets the centre
// kDropped in all three coordinates: no frame step or tap brings it back
// into a frame, reflected or not.
constexpr int kDropped = -(1 << 29);

__device__ __forceinline__ int4 centre_entry(float w, const float* fl, int t, int qh,
                                             int qw, int stride, int T, int Lh, int Lw) {
  int nl_t, nl_h, nl_w;
  if (!nl_centre(fl, t, qh, qw, stride, T, Lh, Lw, &nl_t, &nl_h, &nl_w))
    nl_t = nl_h = nl_w = kDropped;
  return make_int4(__float_as_int(w), nl_t, nl_h, nl_w);
}

// G channels of one pixel, through the read-only path: side by side in a
// channels-last tensor (CL; 16-byte aligned for G >= 4, 8-byte for G = 2),
// or `cs` apart in a planar one, where only the n < G that exist are read
// (the rest are 0)
template <int G, bool CL>
__device__ __forceinline__ void load_channels(float (&x)[G], const float* p, long long cs,
                                              int n) {
  if constexpr (!CL) {
#pragma unroll
    for (int c = 0; c < G; ++c) x[c] = c < n ? __ldg(p + c * cs) : 0.f;
  } else if constexpr (G >= 4) {
#pragma unroll
    for (int c = 0; c < G; c += 4) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(p + c));
      x[c] = v.x; x[c + 1] = v.y; x[c + 2] = v.z; x[c + 3] = v.w;
    }
  } else if constexpr (G == 2) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(p));
    x[0] = v.x; x[1] = v.y;
  } else {
    x[0] = __ldg(p);
  }
}

// the channels a thread of B8 or B9 takes: 8, or all of a pixel's below 8
// (4 for 3 or 4), of a channels-last tensor of Fp channels or a planar
// one of F (B3's rule, agg_gather_fwd.cu)
__host__ __device__ inline int channel_group(int F, int Fp, int cl) {
  const int n = cl ? Fp : F;
  return n >= 8 ? 8 : n > 2 ? 4 : n;
}

}  // namespace
