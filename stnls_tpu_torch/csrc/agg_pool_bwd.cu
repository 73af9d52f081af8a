// B10: PooledPatchSum backward, for Hopper.
//
// Replaces the Pallas TPU kernel stnls_tpu/ops/agg_pallas_sp.py:
// _make_pool_bwd_kernel (the backward of the custom_vjp _pool_op). Plain
// version: stnls_tpu_torch/ops/agg_sp_cuda.py::_pool_bwd_plain, the VJP of
// the plain pool (stnls_tpu_torch/ops/agg.py::nl_pool).
//
// What it computes, from the output cotangent g [B,HD,T,F,ps*nH,ps*nW] and
// the forward's map (agg_pool_fwd.cu) from a (query, slot, frame step,
// tap) to its read pixel r and its output pixel o (ps odd):
//   g_vid[r, c] += w[q,k] * g[o, c] / (1 + 1e-10),
//   g_w[q,k]     = sum over (pk, tap, c) of vid[r, c] * g[o, c] / (1 + 1e-10),
// over the taps the forward kept (its output pixel on the grid, its read
// pixel in the frame). Where the forward zeroed a weight (below 1e-8,
// negative ones too, or a -1e8 fill) both are 0. The offsets are rounded:
// they get no gradient (the wrapper returns zeros).
//
// What bounds it on the H100: bytes. At the agg example's 128^2 it reads
// the 28 MB cotangent, 12.6 MB of weights and offsets and the video, and
// writes the 3.1 MB video gradient by float atomics.
//
// What the design does about it: one thread per (query, slot), with
// neighbouring threads on neighbouring slots of one query: the weight
// gradient is summed in registers and written once (deterministic), and a
// zeroed weight returns at once (after softmax(-10 d) most slots of the
// agg example). The video gradient is a scatter to the non-local read
// pixels: float atomicAdd into a g_vid zeroed by the caller, in no fixed
// order (compare at 1e-4 * max|g|).

#include "agg_common.cuh"

namespace {

struct PoolBwdArgs {
  const float* vid;      // [B,HD,T,F,H,W]
  const float* weights;  // [B,HD,T,nH,nW,K]
  const float* flows;    // [B,HD,T,nH,nW,K,3] as (dt, dh, dw)
  const float* g_out;    // [B,HD,T,F,ps*nH,ps*nW]
  float* g_vid;          // [B,HD,T,F,H,W], zeroed by the caller
  float* g_weights;      // [B,HD,T,nH,nW,K]
  int B, HD, K, T, F, H, W, nH, nW;
  int ps, stride0, pt, dilation, reflect, use_adj, need_vid;
};

__global__ void __launch_bounds__(256) agg_pool_bwd_kernel(PoolBwdArgs a) {
  const long long n = (long long)a.B * a.HD * a.T * a.nH * a.nW * a.K;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float w = a.weights[i];
  int nl_t, nl_h, nl_w;
  long long r = i / a.K;
  const int qw = (int)(r % a.nW);
  r /= a.nW;
  const int qh = (int)(r % a.nH);
  r /= a.nH;
  const int t = (int)(r % a.T);
  const long long bhd = r / a.T;
  if (w < 1e-8f || !nl_centre(a.flows + i * 3, t, qh, qw, a.stride0, a.T, a.H,
                              a.W, &nl_t, &nl_h, &nl_w)) {
    a.g_weights[i] = 0.f;
    return;
  }
  const int outH = a.ps * a.nH, outW = a.ps * a.nW;
  const long long HW = (long long)a.H * a.W, HWo = (long long)outH * outW;
  const int po = a.use_adj ? 0 : -(a.ps / 2);
  const int base = (a.ps - 1) / 2 + 1 + po;     // psHalf + patch_offset
  const float* g = a.g_out + (bhd * a.T + t) * a.F * HWo;
  const float norm = 1.f + 1e-10f;

  float gw = 0.f;
  for (int pk = 0; pk < a.pt; ++pk) {
    const int nt = reflect1(nl_t + pk, a.T);
    if (!inb(nt, a.T)) continue;
    const float* v = a.vid + (bhd * a.T + nt) * a.F * HW;
    float* gv = a.g_vid + (bhd * a.T + nt) * a.F * HW;
    for (int pi = 0; pi < a.ps; ++pi) {
      const int y = qh * a.ps + base + pi;
      const int ph = tap_pos(nl_h, a.dilation * (pi + po), a.H, a.reflect);
      if (!inb(y, outH) || ph < 0) continue;
      for (int pj = 0; pj < a.ps; ++pj) {
        const int x = qw * a.ps + base + pj;
        const int pw = tap_pos(nl_w, a.dilation * (pj + po), a.W, a.reflect);
        if (!inb(x, outW) || pw < 0) continue;
        const long long o = (long long)y * outW + x, ri = (long long)ph * a.W + pw;
        for (int c = 0; c < a.F; ++c) {
          const float gs = g[c * HWo + o] / norm;
          gw += gs * v[c * HW + ri];
          if (a.need_vid) atomicAdd(gv + c * HW + ri, gs * w);
        }
      }
    }
  }
  a.g_weights[i] = gw;
}

}  // namespace

// ps must be odd; g_vid is written only when need_vid. Returns
// cudaGetLastError() after the launch.
extern "C" int stnls_agg_pool_bwd(
    const float* vid, const float* weights, const float* flows,
    const float* g_out, float* g_vid, float* g_weights,
    int B, int HD, int K, int T, int F, int H, int W, int nH, int nW, int ps,
    int stride0, int pt, int dilation, int reflect, int use_adj,
    int need_vid, void* stream_ptr) {
  PoolBwdArgs a{vid, weights, flows, g_out, g_vid, g_weights, B, HD, K, T, F,
                H, W, nH, nW, ps, stride0, pt, dilation, reflect, use_adj,
                need_vid};
  const long long n = (long long)B * HD * T * nH * nW * K;
  if (n == 0) return 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  agg_pool_bwd_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream_ptr)>>>(a);
  return (int)cudaGetLastError();
}
