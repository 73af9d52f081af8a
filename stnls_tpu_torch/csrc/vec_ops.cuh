// Loads, stores and global atomic adds of VW = 1, 2 or 4 neighbouring
// floats as one instruction, for the kernels that read and add into
// channels-last videos ([.., H, W, Fp], a pixel's channels side by side):
// B2 (nls_topk_bwd.cu), B5 (nls_vol_fwd.cu), B6 (nls_vol_bwd.cu), and B7
// and B10 through agg_patch.cuh. The pointer must be aligned to VW floats.

#pragma once

#include <cuda_runtime.h>

namespace {

template <int VW>
__device__ __forceinline__ void vload(float* x, const float* p) {
  if constexpr (VW == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else if constexpr (VW == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x; x[1] = v.y;
  } else {
    x[0] = *p;
  }
}

// the same through the read-only (non-coherent) data path: for data the
// kernel never writes, so that the compiler may move the load past the
// kernel's stores and atomics
template <int VW>
__device__ __forceinline__ void vldg(float* x, const float* p) {
  if constexpr (VW == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else if constexpr (VW == 2) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(p));
    x[0] = v.x; x[1] = v.y;
  } else {
    x[0] = __ldg(p);
  }
}

template <int VW>
__device__ __forceinline__ void vstore(float* p, const float* x) {
  if constexpr (VW == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else if constexpr (VW == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
    *p = x[0];
  }
}

// one global atomic instruction for VW channels (float2/float4 atomicAdd:
// sm_90, global memory only); returns 1, the count
template <int VW>
__device__ __forceinline__ unsigned vatomic(float* p, const float* x) {
  if constexpr (VW == 4) {
    atomicAdd(reinterpret_cast<float4*>(p), make_float4(x[0], x[1], x[2], x[3]));
  } else if constexpr (VW == 2) {
    atomicAdd(reinterpret_cast<float2*>(p), make_float2(x[0], x[1]));
  } else {
    atomicAdd(p, x[0]);
  }
  return 1u;
}

}  // namespace
