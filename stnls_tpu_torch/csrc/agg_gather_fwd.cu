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
// re-read from L2. Short of that, the per-tap geometry (a weight and three
// offsets loaded, reflections, floorf, corner weights) and the reads of
// the bilinear corners.
//
// What the design does about it: gather form, one thread per output pixel
// and slot (b, hd, k, t, y, x) and a group of G <= 8 channels (the grid's
// second dimension runs over the groups, so registers stay bounded at any
// F). The thread resolves each tap's geometry once for its G channels and
// reads the corners from a channels-last copy of the video ([B,HD,T,H,W,
// Fp], Fp >= F zero-padded, made by the wrapper): a corner's G channels
// are one or two 8/16-byte vector loads. For a small stack the wrapper
// passes the planar video instead (cl = 0: G scalar loads a corner, each
// coalesced along x), where the copy's launch would cost more host time
// than the vector loads save (ops/agg_cuda.CHANNELS_LAST_MIN). At the
// slice the channels-last read measured 0.46 ms against 0.80 planar
// (PERF.md); what bounds the kernel now is the corner reads through L1/L2
// and the per-tap geometry, at ~18x the byte bound. Each channel's store
// is a coalesced row along x of [B,HD,K,T,F,H,W], written exactly once; no
// atomics, deterministic, and each output sums its taps in the order
// (pk, pi, pj, corners 00/01/10/11) of the first version. The overlap
// count is computed once a thread.

#include <cuda_runtime.h>

namespace {

struct AggArgs {
  const float* vid;      // [B,HD,T,H,W,Fp] channels-last, or [B,HD,T,F,H,W]
  const float* weights;  // [B,HD,T,nH,nW,K]
  const float* flows;    // [B,HD,T,nH,nW,K,3] as (dt, dh, dw)
  float* out;            // [B,HD,K,T,F,H,W]
  int B, HD, K, T, F, Fp, H, W, nH, nW;
  int ps, stride0, pt, dilation, use_adj, is_int;
};

// the channels a thread takes: 8, or all of a frame's pixel below 8
// (4 for 3 or 4), for a channels-last video of Fp channels or a planar
// one of F
__host__ __device__ inline int group_size(int F, int Fp, int cl) {
  const int n = cl ? Fp : F;
  return n >= 8 ? 8 : n > 2 ? 4 : n;
}

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

// G channels at p: consecutive (channels-last, CL; 16-byte aligned for
// G >= 4, 8 for G = 2) or `cs` apart (planar: only the n < G that exist)
template <int G, bool CL>
__device__ __forceinline__ void gload(float (&x)[G], const float* p, long long cs, int n) {
  if constexpr (!CL) {
#pragma unroll
    for (int c = 0; c < G; ++c) x[c] = c < n ? p[c * cs] : 0.f;
  } else if constexpr (G >= 4) {
#pragma unroll
    for (int c = 0; c < G; c += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + c);
      x[c] = v.x; x[c + 1] = v.y; x[c + 2] = v.z; x[c + 3] = v.w;
    }
  } else if constexpr (G == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x; x[1] = v.y;
  } else {
    x[0] = *p;
  }
}

template <int G, bool CL>
__global__ void __launch_bounds__(256) agg_gather_fwd_pixel_kernel(AggArgs a) {
  const long long n = (long long)a.B * a.HD * a.K * a.T * a.H * a.W;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int f0 = blockIdx.y * G;
  const int x = (int)(i % a.W);
  long long r = i / a.W;
  const int y = (int)(r % a.H);
  r /= a.H;
  const int t = (int)(r % a.T);
  r /= a.T;
  const int k = (int)(r % a.K);
  const long long bhd = r / a.K;

  const int H = a.H, W = a.W, T = a.T, dil = a.dilation, Fp = a.Fp;
  const long long HW = (long long)H * W;
  const long long px = CL ? Fp : 1, cs = CL ? 1 : HW;   // pixel, channel strides
  const int nch = a.F - f0;                             // channels left
  const int po = a.use_adj ? 0 : -(a.ps / 2);

  int cnt_h = 0, cnt_w = 0;
  for (int p = 0; p < a.ps; ++p) {
    cnt_h += query_of(y, dil * (p + po), a.stride0, a.nH) >= 0;
    cnt_w += query_of(x, dil * (p + po), a.stride0, a.nW) >= 0;
  }

  float acc[G];
#pragma unroll
  for (int c = 0; c < G; ++c) acc[c] = 0.f;
  const float* vb = a.vid + bhd * T * HW * Fp + f0 * cs;
  for (int pk = 0; pk < a.pt; ++pk) {
    for (int pi = 0; pi < a.ps; ++pi) {
      const int qh = query_of(y, dil * (pi + po), a.stride0, a.nH);
      if (qh < 0) continue;
      for (int pj = 0; pj < a.ps; ++pj) {
        const int qw = query_of(x, dil * (pj + po), a.stride0, a.nW);
        if (qw < 0) continue;
        const long long e =
            ((bhd * T + t) * a.nH * a.nW + (long long)qh * a.nW + qw) * a.K + k;
        const float w = a.weights[e];
        const float* fl = a.flows + e * 3;
        const int nl_t = reflect_i(t + (int)rintf(fl[0]), T);
        const int ta = pi * dil, tb = pj * dil;
        // the tap's pixel (int) or first corner, fractions and corner rows
        long long o00 = 0, o01 = 0, o10 = 0, o11 = 0;
        float fh = 0.f, fw = 0.f;
        if (a.is_int) {
          const int nl_h = reflect_i(qh * a.stride0 + (int)rintf(fl[1]), H);
          const int nl_w = reflect_i(qw * a.stride0 + (int)rintf(fl[2]), W);
          o00 = ((long long)reflect_i(nl_h + dil * po + ta, H) * W +
                 reflect_i(nl_w + dil * po + tb, W)) * px;
        } else {
          const float nl_h = reflect_f(__fadd_rn((float)(qh * a.stride0), fl[1]), H);
          const float nl_w = reflect_f(__fadd_rn((float)(qw * a.stride0), fl[2]), W);
          const float o_h = __fadd_rn(nl_h, (float)(dil * po));
          const float o_w = __fadd_rn(nl_w, (float)(dil * po));
          const float fi = floorf(o_h), fj = floorf(o_w);
          fh = __fsub_rn(o_h, fi);
          fw = __fsub_rn(o_w, fj);
          const int i0 = (int)fi + ta, j0 = (int)fj + tb;
          const long long h0 = reflect_i(i0, H), h1 = reflect_i(i0 + 1, H);
          const int w0 = reflect_i(j0, W), w1 = reflect_i(j0 + 1, W);
          o00 = (h0 * W + w0) * px;
          o01 = (h0 * W + w1) * px;
          o10 = (h1 * W + w0) * px;
          o11 = (h1 * W + w1) * px;
        }
        const float* v = vb + reflect_i(nl_t + pk, T) * HW * Fp;
        if (a.is_int) {
          float c00[G];
          gload<G, CL>(c00, v + o00, cs, nch);
#pragma unroll
          for (int c = 0; c < G; ++c) acc[c] += c00[c] * w;
          continue;
        }
        const float wh0 = 1.f - fh, ww0 = 1.f - fw;
        float c00[G], c01[G], c10[G], c11[G];
        gload<G, CL>(c00, v + o00, cs, nch);
        gload<G, CL>(c01, v + o01, cs, nch);
        gload<G, CL>(c10, v + o10, cs, nch);
        gload<G, CL>(c11, v + o11, cs, nch);
#pragma unroll
        for (int c = 0; c < G; ++c) {
          float pv = 0.f;
          pv += (wh0 * ww0) * c00[c];
          pv += (wh0 * fw) * c01[c];
          pv += (fh * ww0) * c10[c];
          pv += (fh * fw) * c11[c];
          acc[c] += pv * w;
        }
      }
    }
  }
  const float den = (float)(cnt_h * cnt_w) + 1e-10f;
  float* o = a.out + (((bhd * a.K + k) * T + t) * a.F + f0) * HW + (long long)y * W + x;
#pragma unroll
  for (int c = 0; c < G; ++c)
    if (f0 + c < a.F) o[c * HW] = acc[c] / den;
}

template <bool CL>
void launch(const AggArgs& a, int G, dim3 grid, cudaStream_t s) {
  if (G == 8) agg_gather_fwd_pixel_kernel<8, CL><<<grid, 256, 0, s>>>(a);
  else if (G == 4) agg_gather_fwd_pixel_kernel<4, CL><<<grid, 256, 0, s>>>(a);
  else if (G == 2) agg_gather_fwd_pixel_kernel<2, CL><<<grid, 256, 0, s>>>(a);
  else agg_gather_fwd_pixel_kernel<1, CL><<<grid, 256, 0, s>>>(a);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success). `vid` is
// channels-last with Fp channels (cl = 1: Fp = F for F <= 2, 4 for
// F <= 4, else a multiple of 8) or planar (cl = 0, Fp = F).
extern "C" int stnls_agg_gather_fwd(
    const float* vid, const float* weights, const float* flows, float* out,
    int B, int HD, int K, int T, int F, int Fp, int H, int W, int nH, int nW,
    int ps, int stride0, int pt, int dilation, int use_adj, int is_int,
    int cl, void* stream_ptr) {
  AggArgs a{vid, weights, flows, out, B, HD, K, T, F, Fp, H, W, nH, nW,
            ps, stride0, pt, dilation, use_adj, is_int};
  const int G = group_size(F, Fp, cl);
  if (Fp < F || (!cl && Fp != F) || (cl && Fp % G)) return (int)cudaErrorInvalidValue;
  const long long n = (long long)B * HD * K * T * H * W;
  if (n == 0 || F == 0) return 0;
  const dim3 grid((unsigned)((n + 255) / 256), (unsigned)((F + G - 1) / G));
  const cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  if (cl) launch<true>(a, G, grid, s);
  else launch<false>(a, G, grid, s);
  return (int)cudaGetLastError();
}
