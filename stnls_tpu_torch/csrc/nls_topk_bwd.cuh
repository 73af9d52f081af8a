// B2's argument struct and reflection, shared by the kernel
// (nls_topk_bwd.cu) and its measured variant (variants/
// nls_topk_bwd_tile.cu, which stnls_tpu_torch/b2_b3_variants.py builds).

#pragma once

#include <cuda_runtime.h>

#include "vec_ops.cuh"

namespace {

struct NlsBwdArgs {
  const float* vid0;    // [B,HD,Tv,H,W,Fp] channels-last
  const float* vid1;    // [B,HD,Tv,H,W,Fp]
  const float* prop_h;  // [B,HD,T,nH,nW,K] key positions (integers for int)
  const float* prop_w;
  const int* tj;        // [B,HD,T,nH,nW,K] target frame, -1 for invalid cells
  const float* g_d;     // [B,HD,T,nH,nW,K]
  float* g_vid0;        // [B,HD,Tv,H,W,Fp], zeroed by the caller
  float* g_vid1;        // [B,HD,Tv,H,W,Fp], zeroed by the caller
  float* g_prop_h;      // [B,HD,T,nH,nW,K]
  float* g_prop_w;
  unsigned long long* stats;  // null, or the counts (stnls_nls_topk_bwd)
  int B, HD, T, Fp, H, W, nH, nW, K;
  int Tv, halo;         // video frames, and the frames before the queries
  int ps, stride0, dilation, use_adj, l2, is_int;
  int ng, np;           // lanes (channel groups) a query, channel passes
};

// single reflection, as torch's reflect pad of the plain version reads
__device__ __forceinline__ int reflect_i(int v, int lim) {
  int out = v < 0 ? -v : v;
  out = v > lim - 1 ? 2 * (lim - 1) - v : out;
  return min(max(out, 0), lim - 1);
}

}  // namespace
