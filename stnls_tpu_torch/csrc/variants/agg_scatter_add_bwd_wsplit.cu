// A variant of B8 (stnls_tpu_torch/csrc/agg_scatter_add_bwd.cu) that the
// port does not build; stnls_tpu_torch/b8_b9_variants.py times it against
// the shipped kernel. The shipped tile kernel writes g_vid only, and g_w
// is a launch of its own: 8 lanes a (query, slot), lane l taking the
// channels l, l + 8, ... of every tap, each lane resolving the slot's
// centre itself, then a fixed-order butterfly over the 8 lanes
// (deterministic, but not the first design's summation order). Same C
// interface as the shipped entry.

#define stnls_agg_scatter_add_bwd stnls_agg_scatter_add_bwd_tile
#include "agg_scatter_add_bwd.cu"
#undef stnls_agg_scatter_add_bwd

namespace {

constexpr int kLanes = 8, kSplitThreads = 256;

template <bool CL>
__global__ void __launch_bounds__(kSplitThreads) agg_scatter_add_bwd_w_split_kernel(
    ScatterBwdArgs a, long long n) {
  const long long i = (long long)blockIdx.x * kSplitThreads + threadIdx.x;
  const long long e = i / kLanes;
  const int lane = (int)(i % kLanes);
  float acc = 0.f;
  int nl_t, nl_h, nl_w;
  long long r = e / a.K;
  const int qw = (int)(r % a.nW);
  r /= a.nW;
  const int qh = (int)(r % a.nH);
  r /= a.nH;
  const int t = (int)(r % a.T);
  const long long bhd = r / a.T;
  if (e < n && nl_centre(a.flows + e * 3, t, qh, qw, a.strideOut, a.T, a.outH, a.outW,
                         &nl_t, &nl_h, &nl_w)) {
    const long long HWi = (long long)a.H * a.W, HWo = (long long)a.outH * a.outW;
    const int po = a.use_adj ? 0 : -(a.ps / 2);
    const float* gb = a.g_out + bhd * a.T * HWo * (CL ? a.Fp : a.F);
    for (int pk = 0; pk < a.pt && t + pk < a.T; ++pk) {
      const float* v = a.vid + (bhd * a.T + t + pk) * a.F * HWi;
      int nt = nl_t + pk;
      if (a.reflect) nt = reflect1(nt, a.T);
      if (!inb(nt, a.T)) continue;
      for (int pi = 0; pi < a.ps; ++pi) {
        const int dh = a.dilation * (pi + po);
        const int rh = qh * a.strideIn + dh;
        const int sh = tap_pos(nl_h, dh, a.outH, a.reflect);
        if (!inb(rh, a.H) || sh < 0) continue;
        for (int pj = 0; pj < a.ps; ++pj) {
          const int dw = a.dilation * (pj + po);
          const int rw = qw * a.strideIn + dw;
          const int sw = tap_pos(nl_w, dw, a.outW, a.reflect);
          if (!inb(rw, a.W) || sw < 0) continue;
          const long long ri = (long long)rh * a.W + rw, pix = (long long)sh * a.outW + sw;
          for (int c = lane; c < a.F; c += kLanes) {
            const float g = CL ? gb[(nt * HWo + pix) * a.Fp + c]
                               : gb[((long long)nt * a.F + c) * HWo + pix];
            acc += v[c * HWi + ri] * g;
          }
        }
      }
    }
  }
#pragma unroll
  for (int m = kLanes / 2; m > 0; m /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (e < n && lane == 0) a.g_weights[e] = acc;
}

}  // namespace

extern "C" int stnls_agg_scatter_add_bwd(
    const float* vid, const float* weights, const float* flows,
    const float* g_out, float* g_vid, float* g_weights,
    int B, int HD, int K, int T, int F, int Fp, int H, int W, int nH, int nW,
    int outH, int outW, int ps, int strideIn, int strideOut, int pt,
    int dilation, int reflect, int use_adj, int need_vid, int need_weights,
    int cl, int table_bytes, void* stream_ptr) {
  const long long n = (long long)B * HD * T * nH * nW * K;
  int err = 0;
  if (need_vid || n == 0)
    err = stnls_agg_scatter_add_bwd_tile(
        vid, weights, flows, g_out, g_vid, g_weights, B, HD, K, T, F, Fp, H, W, nH, nW,
        outH, outW, ps, strideIn, strideOut, pt, dilation, reflect, use_adj, need_vid,
        n == 0 ? need_weights : 0, cl, table_bytes, stream_ptr);
  if (err || !need_weights || n == 0) return err;
  ScatterBwdArgs a{vid, weights, flows, g_out, g_vid, g_weights, K, T, F, Fp, H, W, nH, nW,
                   outH, outW, ps, strideIn, strideOut, pt, dilation, reflect, use_adj,
                   need_vid, need_weights, 0, 0, 0};
  const unsigned blocks = (unsigned)((n * kLanes + kSplitThreads - 1) / kSplitThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  if (cl) agg_scatter_add_bwd_w_split_kernel<true><<<blocks, kSplitThreads, 0, s>>>(a, n);
  else agg_scatter_add_bwd_w_split_kernel<false><<<blocks, kSplitThreads, 0, s>>>(a, n);
  return (int)cudaGetLastError();
}
