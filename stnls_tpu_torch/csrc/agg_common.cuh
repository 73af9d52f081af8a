// Index arithmetic shared by the ScatterAdd kernels (B7
// agg_scatter_add_fwd.cu, B8 agg_scatter_add_bwd.cu) and the
// PooledPatchSum kernels (B9 agg_pool_fwd.cu, B10 agg_pool_bwd.cu), so
// that a forward and its backward read and write the same pixels.
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

}  // namespace
