// B2: K-sparse backward of the non-local search, for Hopper.
//
// Replaces the Pallas TPU kernel stnls_tpu/ops/nls_pallas_bwd.py:
// _make_bwd_kernel with emit="topk" (entry topk_bwd_pallas, the backward
// of the custom_vjp _topk_op). Plain version:
// stnls_tpu_torch/ops/nls_cuda.py::nls_topk_bwd_plain, the VJP of
// stnls_tpu_torch/ops/nls_k.py::dists_at_positions.
//
// What it computes: for every query q = (b, hd, t, qh, qw) and selected
// slot k with a valid cell, the distance
//   d[q,k] = sum over taps (pi, pj) and channels f of
//            l2: (p0 - pv)^2   or   prod: p0 * pv,
// p0 = vid0[b,hd,t,f] at the reflected query tap, pv = vid1[b,hd,tj,f] read
// at the key position (prop_h, prop_w)[q,k] plus the tap (bilinear for
// float, at individually reflected corners, as the reflect-padded frame of
// the plain version reads), is differentiated with the cotangent g_d[q,k]:
//   g_vid0 += g * dd/dp0 at the query pixel,
//   g_vid1 += g * dd/dpv * corner weight at each corner's source pixel,
//   g_prop_h/g_prop_w[q,k] = g * sum dd/dpv * dpv/dposition (the bilinear
//   corner derivatives; 0 in the int path and for invalid cells).
// The flows' gradient is chained from the positions in torch
// (ops/nls_k.cells_geometry), as the JAX package chains g_th/g_tw outside
// its kernel. Cells outside the frame (tj < 0) and zero cotangents are
// skipped, so an init-valued (inf) distance never meets a zero. In a
// temporal chunk (time sharding) the videos hold Tv = T + 2*halo frames:
// the query of frame t reads frame t + halo, tj indexes the videos.
//
// What bounds it on the H100: global atomic adds. At the slice config
// (163,840 queries, K=10, ps=3, F=8) one backward adds 9 taps x 8 channels
// x (1 query + 4 corner) values per (q, k): about 5.9e8 float atomics
// into the two 2.6 MB videos (L2-resident), against ~36k floats read per
// query from L1/L2.
//
// What the design does about it: one thread per (q, k) with neighbouring
// threads on neighbouring qw, so a warp's reads and atomics of one tap and
// channel fall on neighbouring addresses of the same rows and merge in L2;
// the position gradients are summed in registers and written once. The
// result of g_vid0/g_vid1 depends on the order of the atomics, so it is
// not bitwise deterministic (sums agree to float rounding); g_prop is
// deterministic. Accumulating a tile's video gradient in shared memory
// before one atomic per pixel is later work.

#include <cuda_runtime.h>

namespace {

struct NlsBwdArgs {
  const float* vid0;    // [B,HD,Tv,F,H,W]
  const float* vid1;    // [B,HD,Tv,F,H,W]
  const float* prop_h;  // [B,HD,T,nH,nW,K] key positions (integers for int)
  const float* prop_w;
  const int* tj;        // [B,HD,T,nH,nW,K] target frame, -1 for invalid cells
  const float* g_d;     // [B,HD,T,nH,nW,K]
  float* g_vid0;        // [B,HD,Tv,F,H,W], zeroed by the caller
  float* g_vid1;        // [B,HD,Tv,F,H,W], zeroed by the caller
  float* g_prop_h;      // [B,HD,T,nH,nW,K]
  float* g_prop_w;
  int B, HD, T, F, H, W, nH, nW, K;
  int Tv, halo;         // video frames, and the frames before the queries
  int ps, stride0, dilation, use_adj, l2, is_int;
};

// single reflection, as torch's reflect pad of the plain version reads
__device__ __forceinline__ int reflect_i(int v, int lim) {
  int out = v < 0 ? -v : v;
  out = v > lim - 1 ? 2 * (lim - 1) - v : out;
  return min(max(out, 0), lim - 1);
}

__global__ void __launch_bounds__(256) nls_topk_bwd_kernel(NlsBwdArgs a) {
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

  const long long q = ((bhd * a.T + t) * a.nH + qh) * a.nW + qw;
  const long long e = q * a.K + k;
  const float g = a.g_d[e];
  const int tj = a.tj[e];
  float gph = 0.f, gpw = 0.f;
  if (tj < 0 || g == 0.f) {
    a.g_prop_h[e] = 0.f;
    a.g_prop_w[e] = 0.f;
    return;
  }

  const int H = a.H, W = a.W, dil = a.dilation;
  const long long HW = (long long)H * W;
  const long long F = a.F;
  const float* v0 = a.vid0 + (bhd * a.Tv + a.halo + t) * F * HW;
  float* gv0 = a.g_vid0 + (bhd * a.Tv + a.halo + t) * F * HW;
  const float* v1 = a.vid1 + (bhd * a.Tv + tj) * F * HW;
  float* gv1 = a.g_vid1 + (bhd * a.Tv + tj) * F * HW;
  const int po = a.use_adj ? 0 : -(a.ps / 2);
  const int ref_h = qh * a.stride0, ref_w = qw * a.stride0;
  const float o_h = __fadd_rn(a.prop_h[e], (float)(dil * po));
  const float o_w = __fadd_rn(a.prop_w[e], (float)(dil * po));
  const float fi = floorf(o_h), fj = floorf(o_w);
  const float fh = __fsub_rn(o_h, fi), fw = __fsub_rn(o_w, fj);
  const int i0 = (int)fi, j0 = (int)fj;
  const float w00 = (1.f - fh) * (1.f - fw), w01 = (1.f - fh) * fw;
  const float w10 = fh * (1.f - fw), w11 = fh * fw;

  for (int pi = 0; pi < a.ps; ++pi) {
    const int qr = reflect_i(ref_h + dil * (pi + po), H);
    const int r0 = reflect_i(i0 + dil * pi, H);
    const int r1 = reflect_i(i0 + dil * pi + 1, H);
    for (int pj = 0; pj < a.ps; ++pj) {
      const long long oq = (long long)qr * W + reflect_i(ref_w + dil * (pj + po), W);
      const int c0 = reflect_i(j0 + dil * pj, W);
      if (a.is_int) {
        const long long o = (long long)r0 * W + c0;
        for (int f = 0; f < a.F; ++f) {
          const float p0 = v0[f * HW + oq], p1 = v1[f * HW + o];
          const float gp0 = a.l2 ? 2.f * g * (p0 - p1) : g * p1;
          const float gp1 = a.l2 ? -gp0 : g * p0;
          atomicAdd(gv0 + f * HW + oq, gp0);
          atomicAdd(gv1 + f * HW + o, gp1);
        }
        continue;
      }
      const int c1 = reflect_i(j0 + dil * pj + 1, W);
      const long long o00 = (long long)r0 * W + c0, o01 = (long long)r0 * W + c1;
      const long long o10 = (long long)r1 * W + c0, o11 = (long long)r1 * W + c1;
      for (int f = 0; f < a.F; ++f) {
        const float p0 = v0[f * HW + oq];
        const float* p = v1 + f * HW;
        const float c00 = p[o00], c01 = p[o01], c10 = p[o10], c11 = p[o11];
        const float pv = w00 * c00 + w01 * c01 + w10 * c10 + w11 * c11;
        const float gp0 = a.l2 ? 2.f * g * (p0 - pv) : g * pv;
        const float gpv = a.l2 ? -gp0 : g * p0;
        atomicAdd(gv0 + f * HW + oq, gp0);
        float* gp = gv1 + f * HW;
        atomicAdd(gp + o00, gpv * w00);
        atomicAdd(gp + o01, gpv * w01);
        atomicAdd(gp + o10, gpv * w10);
        atomicAdd(gp + o11, gpv * w11);
        gph += gpv * ((1.f - fw) * (c10 - c00) + fw * (c11 - c01));
        gpw += gpv * ((1.f - fh) * (c01 - c00) + fh * (c11 - c10));
      }
    }
  }
  a.g_prop_h[e] = a.is_int ? 0.f : gph;
  a.g_prop_w[e] = a.is_int ? 0.f : gpw;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int stnls_nls_topk_bwd(
    const float* vid0, const float* vid1, const float* prop_h,
    const float* prop_w, const int* tj, const float* g_d, float* g_vid0,
    float* g_vid1, float* g_prop_h, float* g_prop_w, int B, int HD, int T,
    int F, int H, int W, int nH, int nW, int K, int Tv, int halo, int ps,
    int stride0, int dilation, int use_adj, int l2, int is_int,
    void* stream_ptr) {
  NlsBwdArgs a{vid0, vid1, prop_h, prop_w, tj, g_d, g_vid0, g_vid1,
               g_prop_h, g_prop_w, B, HD, T, F, H, W, nH, nW, K, Tv, halo,
               ps, stride0, dilation, use_adj, l2, is_int};
  const long long n = (long long)B * HD * T * K * nH * nW;
  if (n == 0) return 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  nls_topk_bwd_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream_ptr)>>>(a);
  return (int)cudaGetLastError();
}
