// B3: NonLocalGather forward, for Hopper.
//
// Replaces the Pallas TPU kernel stnls_tpu/ops/agg_pallas.py:
// _make_fwd_kernel (entry nl_gather_stack_pallas). Plain version:
// stnls_tpu_torch/ops/agg_cuda.py::nl_gather_stack_plain (the port of
// stnls_tpu/ops/agg.py::nl_gather_stack).
//
// What it computes: stack[b,hd,k,t,f,y,x] = sum over the patch taps
// (pk, pi, pj) whose query q = ((y - dH)/stride0, (x - dW)/stride0) lies on
// the query grid of w[q,k] * vid[b,hd,tj,f] read at the tap of q's k-th
// non-local patch (bilinear for float offsets, at reflected corners),
// divided by the patch-overlap count of (y, x).
//
// What bounds it on the H100: the bytes it writes. The stack is K times
// the video: 52 MB at the slice config (B=1, HD=2, K=10, T=5, F=8, 128^2),
// against ~1 MB of weights and offsets and a 2.6 MB video that the taps
// re-read from L2.
//
// What the design does about it: gather form, one thread per output
// element with neighbouring threads on neighbouring x, so every store is
// coalesced and written exactly once; each thread sums its own taps, so
// there are no atomics and the result is deterministic. Reads of weights,
// offsets and video hit L1/L2. Reusing one query's geometry across F and
// across the taps of a tile is later work.

#include <cuda_runtime.h>

namespace {

struct AggArgs {
  const float* vid;      // [B,HD,T,F,H,W]
  const float* weights;  // [B,HD,T,nH,nW,K]
  const float* flows;    // [B,HD,T,nH,nW,K,3] as (dt, dh, dw)
  float* out;            // [B,HD,K,T,F,H,W]
  int B, HD, K, T, F, H, W, nH, nW;
  int ps, stride0, pt, dilation, use_adj, is_int;
};

__device__ __forceinline__ int reflect_i(int v, int lim) {
  int out = v < 0 ? -v : v;
  out = v > lim - 1 ? 2 * (lim - 1) - v : out;
  return min(max(out, 0), lim - 1);
}

__device__ __forceinline__ float reflect_f(float v, int lim) {
  float out = v < 0.f ? -v : v;
  return v > (float)(lim - 1) ? __fsub_rn((float)(2 * (lim - 1)), v) : out;
}

// query index along one axis for patch offset d, or -1 off the grid
__device__ __forceinline__ int query_of(int pos, int d, int stride, int n) {
  const int p = pos - d;
  if (p < 0 || p % stride) return -1;
  const int qi = p / stride;
  return qi < n ? qi : -1;
}

__global__ void __launch_bounds__(256) agg_gather_kernel(AggArgs a) {
  const long long n = (long long)a.B * a.HD * a.K * a.T * a.F * a.H * a.W;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int x = (int)(i % a.W);
  long long r = i / a.W;
  const int y = (int)(r % a.H);
  r /= a.H;
  const int f = (int)(r % a.F);
  r /= a.F;
  const int t = (int)(r % a.T);
  r /= a.T;
  const int k = (int)(r % a.K);
  r /= a.K;
  const int hd = (int)(r % a.HD);
  const int b = (int)(r / a.HD);

  const int H = a.H, W = a.W, T = a.T, dil = a.dilation;
  const long long HW = (long long)H * W;
  const int po = a.use_adj ? 0 : -(a.ps / 2);

  int cnt_h = 0, cnt_w = 0;
  for (int p = 0; p < a.ps; ++p) {
    cnt_h += query_of(y, dil * (p + po), a.stride0, a.nH) >= 0;
    cnt_w += query_of(x, dil * (p + po), a.stride0, a.nW) >= 0;
  }

  float acc = 0.f;
  for (int pk = 0; pk < a.pt; ++pk) {
    for (int pi = 0; pi < a.ps; ++pi) {
      const int qh = query_of(y, dil * (pi + po), a.stride0, a.nH);
      if (qh < 0) continue;
      for (int pj = 0; pj < a.ps; ++pj) {
        const int qw = query_of(x, dil * (pj + po), a.stride0, a.nW);
        if (qw < 0) continue;
        const long long q = (((long long)b * a.HD + hd) * T + t) * a.nH * a.nW +
                            (long long)qh * a.nW + qw;
        const float w = a.weights[q * a.K + k];
        const float* fl = a.flows + (q * a.K + k) * 3;
        const int nl_t = reflect_i(t + (int)rintf(fl[0]), T);
        const int tj = reflect_i(nl_t + pk, T);
        const float* v = a.vid + ((((long long)b * a.HD + hd) * T + tj) * a.F + f) * HW;
        const int ta = pi * dil, tb = pj * dil;
        float pv;
        if (a.is_int) {
          const int nl_h = reflect_i(qh * a.stride0 + (int)rintf(fl[1]), H);
          const int nl_w = reflect_i(qw * a.stride0 + (int)rintf(fl[2]), W);
          pv = v[reflect_i(nl_h + dil * po + ta, H) * W + reflect_i(nl_w + dil * po + tb, W)];
        } else {
          const float nl_h = reflect_f(__fadd_rn((float)(qh * a.stride0), fl[1]), H);
          const float nl_w = reflect_f(__fadd_rn((float)(qw * a.stride0), fl[2]), W);
          const float o_h = __fadd_rn(nl_h, (float)(dil * po));
          const float o_w = __fadd_rn(nl_w, (float)(dil * po));
          const float fi = floorf(o_h), fj = floorf(o_w);
          const float fh = __fsub_rn(o_h, fi), fw = __fsub_rn(o_w, fj);
          const int i0 = (int)fi + ta, j0 = (int)fj + tb;
          const int h0 = reflect_i(i0, H), h1 = reflect_i(i0 + 1, H);
          const int w0 = reflect_i(j0, W), w1 = reflect_i(j0 + 1, W);
          const float wh0 = 1.f - fh, ww0 = 1.f - fw;
          pv = 0.f;
          pv += (wh0 * ww0) * v[h0 * W + w0];
          pv += (wh0 * fw) * v[h0 * W + w1];
          pv += (fh * ww0) * v[h1 * W + w0];
          pv += (fh * fw) * v[h1 * W + w1];
        }
        acc += pv * w;
      }
    }
  }
  a.out[i] = acc / ((float)(cnt_h * cnt_w) + 1e-10f);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int stnls_agg_gather_fwd(
    const float* vid, const float* weights, const float* flows, float* out,
    int B, int HD, int K, int T, int F, int H, int W, int nH, int nW, int ps,
    int stride0, int pt, int dilation, int use_adj, int is_int,
    void* stream_ptr) {
  AggArgs a{vid, weights, flows, out, B, HD, K, T, F, H, W, nH, nW,
            ps, stride0, pt, dilation, use_adj, is_int};
  const long long n = (long long)B * HD * K * T * F * H * W;
  if (n == 0) return 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  agg_gather_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream_ptr)>>>(a);
  return (int)cudaGetLastError();
}
