// B4: NonLocalGather backward, for Hopper.
//
// Replaces the Pallas TPU kernel stnls_tpu/ops/agg_pallas_bwd.py:
// _make_bwd_kernel (entry agg_bwd_pallas, the backward of the custom_vjp
// _agg_op). Plain version: stnls_tpu_torch/ops/agg_cuda.py::
// _gather_bwd_plain, the VJP of the plain gather
// (stnls_tpu_torch/ops/agg.py::nl_gather_stack).
//
// What it computes, from the stack cotangent g [B,HD,K,T,F,H,W] of the
// count-normalised forward (csrc/agg_gather_fwd.cu), for every query q and
// slot k: with gs = g / (overlap count + 1e-10) at the reference pixel
// (y, x) of each patch tap that lies in the frame, and pv the value the
// forward read there (bilinear for float, at reflected corners),
//   g_weights[q,k]  = sum over taps, pt and channels of gs * pv,
//   g_vid          += gs * w[q,k] * corner weight at each corner's source
//                     pixel (the transpose of the forward's reads),
//   g_flows[q,k]    = (0, dh, dw): the bilinear corner derivatives times
//                     gs * w, with the sign of the centre's reflection;
//                     dt and the whole int path get 0.
//
// What bounds it on the H100: global atomic adds into g_vid. At the slice
// config (163,840 queries, K=10, ps=3, F=8) one backward adds 9 taps x 8
// channels x 4 corners per (q, k): about 4.7e8 float atomics into a
// 2.6 MB video (L2-resident), against a 52 MB cotangent read once.
//
// What the design does about it: one thread per (q, k) with neighbouring
// threads on neighbouring qw, so a warp's cotangent reads are coalesced
// and its corner reads and atomics of one tap fall on neighbouring
// addresses; g_weights and g_flows are summed in registers and written
// once (deterministic). g_vid depends on the order of the atomics and is
// not bitwise deterministic. A shared-memory tile of g_vid is later work.

#include <cuda_runtime.h>

namespace {

struct AggBwdArgs {
  const float* vid;      // [B,HD,T,F,H,W]
  const float* weights;  // [B,HD,T,nH,nW,K]
  const float* flows;    // [B,HD,T,nH,nW,K,3] as (dt, dh, dw)
  const float* g_stack;  // [B,HD,K,T,F,H,W]
  float* g_vid;          // [B,HD,T,F,H,W], zeroed by the caller
  float* g_weights;      // [B,HD,T,nH,nW,K]
  float* g_flows;        // [B,HD,T,nH,nW,K,3]
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

// derivative of reflect_f: -1 where the value was folded back
__device__ __forceinline__ float reflect_sign(float v, int lim) {
  return (v < 0.f || v > (float)(lim - 1)) ? -1.f : 1.f;
}

// number of queries whose tap covers position pos along one axis
__device__ __forceinline__ int fold_count(int pos, const AggBwdArgs& a, int n, int po) {
  int c = 0;
  for (int p = 0; p < a.ps; ++p) {
    const int d = pos - a.dilation * (p + po);
    c += d >= 0 && d % a.stride0 == 0 && d / a.stride0 < n;
  }
  return c;
}

__global__ void __launch_bounds__(256) agg_gather_bwd_kernel(AggBwdArgs a) {
  const long long n = (long long)a.B * a.HD * a.T * a.K * a.nH * a.nW;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int qw = (int)(i % a.nW);
  long long r = i / a.nW;
  const int qh = (int)(r % a.nH);
  r /= a.nH;
  const int k = (int)(r % a.K);
  r /= a.K;
  const int t = (int)(r % a.T);
  const long long bhd = r / a.T;

  const int H = a.H, W = a.W, T = a.T, dil = a.dilation;
  const long long HW = (long long)H * W;
  const long long F = a.F;
  const int po = a.use_adj ? 0 : -(a.ps / 2);
  const long long e = (((bhd * T + t) * a.nH + qh) * a.nW + qw) * a.K + k;
  const float w = a.weights[e];
  const float* fl = a.flows + e * 3;
  const int nl_t = reflect_i(t + (int)rintf(fl[0]), T);
  // cotangent of this (k, t): [F,H,W]
  const float* gst = a.g_stack + ((bhd * a.K + k) * T + t) * F * HW;

  int i0, j0;
  float fh = 0.f, fw = 0.f, sgn_h = 0.f, sgn_w = 0.f;
  if (a.is_int) {
    i0 = reflect_i(qh * a.stride0 + (int)rintf(fl[1]), H) + dil * po;
    j0 = reflect_i(qw * a.stride0 + (int)rintf(fl[2]), W) + dil * po;
  } else {
    const float raw_h = __fadd_rn((float)(qh * a.stride0), fl[1]);
    const float raw_w = __fadd_rn((float)(qw * a.stride0), fl[2]);
    sgn_h = reflect_sign(raw_h, H);
    sgn_w = reflect_sign(raw_w, W);
    const float o_h = __fadd_rn(reflect_f(raw_h, H), (float)(dil * po));
    const float o_w = __fadd_rn(reflect_f(raw_w, W), (float)(dil * po));
    const float fi = floorf(o_h), fj = floorf(o_w);
    fh = __fsub_rn(o_h, fi);
    fw = __fsub_rn(o_w, fj);
    i0 = (int)fi;
    j0 = (int)fj;
  }
  const float w00 = (1.f - fh) * (1.f - fw), w01 = (1.f - fh) * fw;
  const float w10 = fh * (1.f - fw), w11 = fh * fw;

  float gw = 0.f, gfh = 0.f, gfw = 0.f;
  for (int pk = 0; pk < a.pt; ++pk) {
    const int tj = reflect_i(nl_t + pk, T);
    const float* v = a.vid + (bhd * T + tj) * F * HW;
    float* gv = a.g_vid + (bhd * T + tj) * F * HW;
    for (int pi = 0; pi < a.ps; ++pi) {
      const int y = qh * a.stride0 + dil * (pi + po);
      if (y < 0 || y >= H) continue;
      const int cnt_h = fold_count(y, a, a.nH, po);
      const int r0 = reflect_i(i0 + dil * pi, H);
      const int r1 = reflect_i(i0 + dil * pi + 1, H);
      for (int pj = 0; pj < a.ps; ++pj) {
        const int x = qw * a.stride0 + dil * (pj + po);
        if (x < 0 || x >= W) continue;
        const float cnt = (float)(cnt_h * fold_count(x, a, a.nW, po)) + 1e-10f;
        const long long og = (long long)y * W + x;
        const int c0 = reflect_i(j0 + dil * pj, W);
        if (a.is_int) {
          const long long o = (long long)r0 * W + c0;
          for (int f = 0; f < a.F; ++f) {
            const float gs = gst[f * HW + og] / cnt;
            gw += gs * v[f * HW + o];
            atomicAdd(gv + f * HW + o, gs * w);
          }
          continue;
        }
        const int c1 = reflect_i(j0 + dil * pj + 1, W);
        const long long o00 = (long long)r0 * W + c0, o01 = (long long)r0 * W + c1;
        const long long o10 = (long long)r1 * W + c0, o11 = (long long)r1 * W + c1;
        for (int f = 0; f < a.F; ++f) {
          const float gs = gst[f * HW + og] / cnt;
          const float* p = v + f * HW;
          const float c00 = p[o00], c01 = p[o01], c10 = p[o10], c11 = p[o11];
          gw += gs * (w00 * c00 + w01 * c01 + w10 * c10 + w11 * c11);
          const float gsw = gs * w;
          float* gp = gv + f * HW;
          atomicAdd(gp + o00, gsw * w00);
          atomicAdd(gp + o01, gsw * w01);
          atomicAdd(gp + o10, gsw * w10);
          atomicAdd(gp + o11, gsw * w11);
          gfh += gsw * ((1.f - fw) * (c10 - c00) + fw * (c11 - c01));
          gfw += gsw * ((1.f - fh) * (c01 - c00) + fh * (c11 - c10));
        }
      }
    }
  }
  a.g_weights[e] = gw;
  float* gf = a.g_flows + e * 3;
  gf[0] = 0.f;
  gf[1] = sgn_h * gfh;
  gf[2] = sgn_w * gfw;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int stnls_agg_gather_bwd(
    const float* vid, const float* weights, const float* flows,
    const float* g_stack, float* g_vid, float* g_weights, float* g_flows,
    int B, int HD, int K, int T, int F, int H, int W, int nH, int nW, int ps,
    int stride0, int pt, int dilation, int use_adj, int is_int,
    void* stream_ptr) {
  AggBwdArgs a{vid, weights, flows, g_stack, g_vid, g_weights, g_flows,
               B, HD, K, T, F, H, W, nH, nW, ps, stride0, pt, dilation,
               use_adj, is_int};
  const long long n = (long long)B * HD * T * K * nH * nW;
  if (n == 0) return 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  agg_gather_bwd_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream_ptr)>>>(a);
  return (int)cudaGetLastError();
}
