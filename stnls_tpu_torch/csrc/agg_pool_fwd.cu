// B9: PooledPatchSum forward, for Hopper.
//
// Replaces the Pallas TPU kernel stnls_tpu/ops/agg_pallas_sp.py:
// _make_pool_fwd_kernel (entry nl_pool_pallas). Plain version:
// stnls_tpu_torch/ops/agg_sp_cuda.py::nl_pool_plain (the port of
// stnls_tpu/ops/agg.py::nl_pool).
//
// What it computes, with ps odd (the wrapper forces it), psHalf =
// (ps-1)/2 + 1 and taps d = dilation * (p + patch_offset): the output
// [B,HD,T,F,ps*nH,ps*nW] at (q*ps + psHalf + p + patch_offset) for query q
// of the stride0 grid and tap p = (pi, pj) is
//   sum over pk, k of w[q,k] * vid[nt, c, reflect(nl_h + d_h), reflect(nl_w + d_w)]
// with the rounded offsets' centre (nl_t, nl_h, nl_w) reflected once over
// the frame and nt = reflect(nl_t + pk). Weights below 1e-8, reads outside
// the frame and -1e8 fills add nothing. Every output pixel is written by
// at most one (query, tap); it is divided by that count + 1e-10, as the
// plain version does (a pixel no tap reaches is 0).
//
// What bounds it on the H100: bytes. At the agg example's 128^2 it writes
// a 28 MB output (ps^2 = 9 times the video) and reads 12.6 MB of weights
// and offsets and the 3.1 MB video.
//
// What the design does about it: gather form. One thread per output
// element, with neighbouring threads on neighbouring x, so the stores are
// coalesced and each is written once, without atomics (deterministic);
// the thread finds its (query, tap) by division and sums its K slots in
// registers. Weights and offsets are re-read by the ps^2 * F threads of a
// query, from L1/L2.

#include "agg_common.cuh"

namespace {

struct PoolArgs {
  const float* vid;      // [B,HD,T,F,H,W]
  const float* weights;  // [B,HD,T,nH,nW,K]
  const float* flows;    // [B,HD,T,nH,nW,K,3] as (dt, dh, dw)
  float* out;            // [B,HD,T,F,ps*nH,ps*nW]
  int B, HD, K, T, F, H, W, nH, nW;
  int ps, stride0, pt, dilation, reflect, use_adj;
};

// The query index and tap of output position `pos` along one axis (ps odd),
// or false if no tap writes there.
__device__ __forceinline__ bool owner(int pos, int ps, int po, int n, int* q, int* p) {
  const int base = (ps - 1) / 2 + 1 + po;    // psHalf + patch_offset
  for (int pp = 0; pp < ps; ++pp) {
    const int u = pos - (base + pp);
    if (u >= 0 && u % ps == 0 && u / ps < n) {
      *q = u / ps;
      *p = pp;
      return true;
    }
  }
  return false;
}

__global__ void __launch_bounds__(256) agg_pool_fwd_kernel(PoolArgs a) {
  const int outH = a.ps * a.nH, outW = a.ps * a.nW;
  const long long n = (long long)a.B * a.HD * a.T * a.F * outH * outW;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int x = (int)(i % outW);
  long long r = i / outW;
  const int y = (int)(r % outH);
  r /= outH;
  const int c = (int)(r % a.F);
  r /= a.F;
  const int t = (int)(r % a.T);
  const long long bhd = r / a.T;
  const int po = a.use_adj ? 0 : -(a.ps / 2);

  int qh, qw, pi, pj;
  if (!owner(y, a.ps, po, a.nH, &qh, &pi) || !owner(x, a.ps, po, a.nW, &qw, &pj)) {
    a.out[i] = 0.f;
    return;
  }
  const long long HW = (long long)a.H * a.W;
  const int dh = a.dilation * (pi + po), dw = a.dilation * (pj + po);
  const long long q = ((bhd * a.T + t) * a.nH + qh) * a.nW + qw;
  float acc = 0.f;
  for (int pk = 0; pk < a.pt; ++pk) {
    for (int k = 0; k < a.K; ++k) {
      const float w = a.weights[q * a.K + k];
      if (w < 1e-8f) continue;
      int nl_t, nl_h, nl_w;
      if (!nl_centre(a.flows + (q * a.K + k) * 3, t, qh, qw, a.stride0, a.T,
                     a.H, a.W, &nl_t, &nl_h, &nl_w))
        continue;
      const int nt = reflect1(nl_t + pk, a.T);
      const int ph = tap_pos(nl_h, dh, a.H, a.reflect);
      const int pw = tap_pos(nl_w, dw, a.W, a.reflect);
      if (!inb(nt, a.T) || ph < 0 || pw < 0) continue;
      acc += w * a.vid[((bhd * a.T + nt) * a.F + c) * HW + (long long)ph * a.W + pw];
    }
  }
  a.out[i] = acc / (1.f + 1e-10f);
}

}  // namespace

// ps must be odd. Returns cudaGetLastError() after the launch.
extern "C" int stnls_agg_pool_fwd(
    const float* vid, const float* weights, const float* flows, float* out,
    int B, int HD, int K, int T, int F, int H, int W, int nH, int nW, int ps,
    int stride0, int pt, int dilation, int reflect, int use_adj,
    void* stream_ptr) {
  PoolArgs a{vid, weights, flows, out, B, HD, K, T, F, H, W, nH, nW, ps,
             stride0, pt, dilation, reflect, use_adj};
  const long long n = (long long)B * HD * T * F * (ps * nH) * (ps * nW);
  if (n == 0) return 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  agg_pool_fwd_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream_ptr)>>>(a);
  return (int)cudaGetLastError();
}
