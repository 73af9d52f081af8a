// B7: NonLocalScatterAdd forward, for Hopper.
//
// Replaces the Pallas TPU kernel stnls_tpu/ops/agg_pallas_sp.py:
// _make_scatter_add_fwd_kernel (entry nl_scatter_add_pallas). Plain
// version: stnls_tpu_torch/ops/agg_sp_cuda.py::nl_scatter_add_plain (the
// port of stnls_tpu/ops/agg.py::nl_scatter_add).
//
// What it computes, for every query q = (t, qh, qw) of the strideIn grid,
// slot k, frame step pk and patch tap p = (pi, pj) at d = dilation * (p +
// patch_offset):
//   out[nt, c, reflect(nl_h + d_h), reflect(nl_w + d_w)]
//       += w[q,k] * vid[t + pk, c, qh*strideIn + d_h, qw*strideIn + d_w]
// with the rounded offsets' centre (nl_t, nl_h, nl_w) taken on the
// strideOut grid of the (outH, outW) output and reflected once, nt =
// nl_t + pk (reflected when reflect_bounds). Read-side taps outside the
// frame, a read frame t + pk >= T, destinations outside the output and
// -1e8 fills are dropped. The output is not normalised.
//
// What bounds it on the H100: bytes. At the agg example's 128^2 it reads
// 12.6 MB of weights and offsets and a 3.1 MB video and writes a 3.1 MB
// output, against ~1e8 flops; but the output is written by float atomics,
// read-modify-write in L2, one per (query, slot, tap, channel).
//
// What the design does about it: one thread per (query, slot), with
// neighbouring threads on neighbouring slots of one query, so the weight
// and offset reads are coalesced and the query patch is read once per
// warp from L1. There is no cheap inverse of the non-local map, so the
// scatter stays a scatter: float atomicAdd into an output zeroed by the
// caller, in no fixed order (compare at 1e-4). A zero weight adds nothing
// and is skipped.

#include "agg_common.cuh"

namespace {

struct ScatterArgs {
  const float* vid;      // [B,HD,T,F,H,W]
  const float* weights;  // [B,HD,T,nH,nW,K]
  const float* flows;    // [B,HD,T,nH,nW,K,3] as (dt, dh, dw)
  float* out;            // [B,HD,T,F,outH,outW], zeroed by the caller
  int B, HD, K, T, F, H, W, nH, nW, outH, outW;
  int ps, strideIn, strideOut, pt, dilation, reflect, use_adj;
};

__global__ void __launch_bounds__(256) agg_scatter_add_fwd_kernel(ScatterArgs a) {
  const long long n = (long long)a.B * a.HD * a.T * a.nH * a.nW * a.K;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float w = a.weights[i];
  if (w == 0.f) return;
  long long r = i / a.K;
  const int qw = (int)(r % a.nW);
  r /= a.nW;
  const int qh = (int)(r % a.nH);
  r /= a.nH;
  const int t = (int)(r % a.T);
  const long long bhd = r / a.T;

  int nl_t, nl_h, nl_w;
  if (!nl_centre(a.flows + i * 3, t, qh, qw, a.strideOut, a.T, a.outH, a.outW,
                 &nl_t, &nl_h, &nl_w))
    return;
  const long long HWi = (long long)a.H * a.W, HWo = (long long)a.outH * a.outW;
  const int po = a.use_adj ? 0 : -(a.ps / 2);
  for (int pk = 0; pk < a.pt; ++pk) {
    const int rt = t + pk;
    if (rt >= a.T) break;
    int nt = nl_t + pk;
    if (a.reflect) nt = reflect1(nt, a.T);
    if (!inb(nt, a.T)) continue;
    const float* v = a.vid + (bhd * a.T + rt) * a.F * HWi;
    float* o = a.out + (bhd * a.T + nt) * a.F * HWo;
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
        const long long ri = (long long)rh * a.W + rw;
        const long long si = (long long)sh * a.outW + sw;
        for (int c = 0; c < a.F; ++c) atomicAdd(o + c * HWo + si, w * v[c * HWi + ri]);
      }
    }
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int stnls_agg_scatter_add_fwd(
    const float* vid, const float* weights, const float* flows, float* out,
    int B, int HD, int K, int T, int F, int H, int W, int nH, int nW,
    int outH, int outW, int ps, int strideIn, int strideOut, int pt,
    int dilation, int reflect, int use_adj, void* stream_ptr) {
  ScatterArgs a{vid, weights, flows, out, B, HD, K, T, F, H, W, nH, nW,
                outH, outW, ps, strideIn, strideOut, pt, dilation, reflect,
                use_adj};
  const long long n = (long long)B * HD * T * nH * nW * K;
  if (n == 0) return 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  agg_scatter_add_fwd_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream_ptr)>>>(a);
  return (int)cudaGetLastError();
}
