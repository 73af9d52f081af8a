// B8: NonLocalScatterAdd backward, for Hopper.
//
// Replaces the Pallas TPU kernel stnls_tpu/ops/agg_pallas_sp.py:
// _make_scatter_add_bwd_kernel (the backward of the custom_vjp _sadd_op).
// Plain version: stnls_tpu_torch/ops/agg_sp_cuda.py::
// _scatter_add_bwd_plain, the VJP of the plain ScatterAdd
// (stnls_tpu_torch/ops/agg.py::nl_scatter_add).
//
// What it computes, from the output cotangent g [B,HD,T,F,outH,outW] and
// the forward's map of B7 (agg_scatter_add_fwd.cu) from a read pixel u =
// q + p of frame t + pk to its destination s_k(q, p, pk):
//   g_vid[t + pk, c, u] = sum over (p, pk, k) of w[q,k] * g[s_k(q,p,pk), c]
//                         with q = u - p on the strideIn grid,
//   g_w[q,k]            = sum over (p, pk, c) of vid[t + pk, c, q + p] *
//                         g[s_k(q,p,pk), c],
// over the taps the forward kept. The offsets are rounded: they get no
// gradient (the wrapper returns zeros).
//
// What bounds it on the H100: bytes. At the agg example's 128^2 it reads
// the 3.1 MB cotangent, the video and 12.6 MB of weights and offsets and
// writes a 3.1 MB video gradient and 3.1 MB of weight gradients; the
// cotangent is gathered at the forward's scattered destinations (L2).
//
// What the design does about it: no atomics, deterministic. The reference
// side is a regular grid, so g_vid is in gather form: one thread per
// video element, with neighbouring threads on neighbouring x, visiting
// the (tap, frame step, slot) entries whose read pixel it is. g_w is one
// thread per (query, slot), as the forward, summed in registers.

#include "agg_common.cuh"

namespace {

struct ScatterBwdArgs {
  const float* vid;      // [B,HD,T,F,H,W]
  const float* weights;  // [B,HD,T,nH,nW,K]
  const float* flows;    // [B,HD,T,nH,nW,K,3] as (dt, dh, dw)
  const float* g_out;    // [B,HD,T,F,outH,outW]
  float* g_vid;          // [B,HD,T,F,H,W]
  float* g_weights;      // [B,HD,T,nH,nW,K]
  int B, HD, K, T, F, H, W, nH, nW, outH, outW;
  int ps, strideIn, strideOut, pt, dilation, reflect, use_adj;
};

// Destination of the tap (dh, dw) of frame step pk of a (query, slot)
// whose centre is (nl_t, nl_h, nl_w): the offset of its cotangent plane
// and pixel, or false where the forward dropped it.
__device__ __forceinline__ bool dest(const ScatterBwdArgs& a, long long bhd, int nl_t,
                                     int nl_h, int nl_w, int pk, int dh, int dw,
                                     long long* plane, long long* pix) {
  int nt = nl_t + pk;
  if (a.reflect) nt = reflect1(nt, a.T);
  const int sh = tap_pos(nl_h, dh, a.outH, a.reflect);
  const int sw = tap_pos(nl_w, dw, a.outW, a.reflect);
  if (!inb(nt, a.T) || sh < 0 || sw < 0) return false;
  *plane = (bhd * a.T + nt) * a.F;
  *pix = (long long)sh * a.outW + sw;
  return true;
}

__global__ void __launch_bounds__(256) agg_scatter_add_bwd_vid_kernel(ScatterBwdArgs a) {
  const long long n = (long long)a.B * a.HD * a.T * a.F * a.H * a.W;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int x = (int)(i % a.W);
  long long r = i / a.W;
  const int y = (int)(r % a.H);
  r /= a.H;
  const int c = (int)(r % a.F);
  r /= a.F;
  const int t = (int)(r % a.T);
  const long long bhd = r / a.T;
  const long long HWo = (long long)a.outH * a.outW;
  const int po = a.use_adj ? 0 : -(a.ps / 2);

  float acc = 0.f;
  for (int pk = 0; pk < a.pt; ++pk) {
    const int tq = t - pk;                 // the query frame reading frame t
    if (tq < 0) break;
    for (int pi = 0; pi < a.ps; ++pi) {
      const int dh = a.dilation * (pi + po);
      const int yq = y - dh;
      if (yq < 0 || yq % a.strideIn) continue;
      const int qh = yq / a.strideIn;
      if (qh >= a.nH) continue;
      for (int pj = 0; pj < a.ps; ++pj) {
        const int dw = a.dilation * (pj + po);
        const int xq = x - dw;
        if (xq < 0 || xq % a.strideIn) continue;
        const int qw = xq / a.strideIn;
        if (qw >= a.nW) continue;
        const long long q = ((bhd * a.T + tq) * a.nH + qh) * a.nW + qw;
        for (int k = 0; k < a.K; ++k) {
          const long long e = q * a.K + k;
          const float w = a.weights[e];
          if (w == 0.f) continue;
          int nl_t, nl_h, nl_w;
          long long plane, pix;
          if (!nl_centre(a.flows + e * 3, tq, qh, qw, a.strideOut, a.T, a.outH,
                         a.outW, &nl_t, &nl_h, &nl_w) ||
              !dest(a, bhd, nl_t, nl_h, nl_w, pk, dh, dw, &plane, &pix))
            continue;
          acc += w * a.g_out[(plane + c) * HWo + pix];
        }
      }
    }
  }
  a.g_vid[i] = acc;
}

__global__ void __launch_bounds__(256) agg_scatter_add_bwd_w_kernel(ScatterBwdArgs a) {
  const long long n = (long long)a.B * a.HD * a.T * a.nH * a.nW * a.K;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  long long r = i / a.K;
  const int qw = (int)(r % a.nW);
  r /= a.nW;
  const int qh = (int)(r % a.nH);
  r /= a.nH;
  const int t = (int)(r % a.T);
  const long long bhd = r / a.T;
  const long long HWi = (long long)a.H * a.W, HWo = (long long)a.outH * a.outW;
  const int po = a.use_adj ? 0 : -(a.ps / 2);

  float acc = 0.f;
  int nl_t, nl_h, nl_w;
  if (nl_centre(a.flows + i * 3, t, qh, qw, a.strideOut, a.T, a.outH, a.outW,
                &nl_t, &nl_h, &nl_w)) {
    for (int pk = 0; pk < a.pt && t + pk < a.T; ++pk) {
      const float* v = a.vid + (bhd * a.T + t + pk) * a.F * HWi;
      for (int pi = 0; pi < a.ps; ++pi) {
        const int dh = a.dilation * (pi + po);
        const int rh = qh * a.strideIn + dh;
        if (!inb(rh, a.H)) continue;
        for (int pj = 0; pj < a.ps; ++pj) {
          const int dw = a.dilation * (pj + po);
          const int rw = qw * a.strideIn + dw;
          long long plane, pix;
          if (!inb(rw, a.W) || !dest(a, bhd, nl_t, nl_h, nl_w, pk, dh, dw, &plane, &pix))
            continue;
          const float* g = a.g_out + plane * HWo + pix;
          const long long ri = (long long)rh * a.W + rw;
          for (int c = 0; c < a.F; ++c) acc += v[c * HWi + ri] * g[c * HWo];
        }
      }
    }
  }
  a.g_weights[i] = acc;
}

}  // namespace

// Launches the g_vid and g_weights kernels where asked (need_vid,
// need_weights). Returns cudaGetLastError() after the launches.
extern "C" int stnls_agg_scatter_add_bwd(
    const float* vid, const float* weights, const float* flows,
    const float* g_out, float* g_vid, float* g_weights,
    int B, int HD, int K, int T, int F, int H, int W, int nH, int nW,
    int outH, int outW, int ps, int strideIn, int strideOut, int pt,
    int dilation, int reflect, int use_adj, int need_vid, int need_weights,
    void* stream_ptr) {
  ScatterBwdArgs a{vid, weights, flows, g_out, g_vid, g_weights, B, HD, K, T,
                   F, H, W, nH, nW, outH, outW, ps, strideIn, strideOut, pt,
                   dilation, reflect, use_adj};
  const int threads = 256;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long n_vid = (long long)B * HD * T * F * H * W;
  if (need_vid && n_vid > 0) {
    const unsigned blocks = (unsigned)((n_vid + threads - 1) / threads);
    agg_scatter_add_bwd_vid_kernel<<<blocks, threads, 0, stream>>>(a);
    const int err = (int)cudaGetLastError();
    if (err) return err;
  }
  const long long n_w = (long long)B * HD * T * nH * nW * K;
  if (need_weights && n_w > 0) {
    const unsigned blocks = (unsigned)((n_w + threads - 1) / threads);
    agg_scatter_add_bwd_w_kernel<<<blocks, threads, 0, stream>>>(a);
  }
  return (int)cudaGetLastError();
}
