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
// Layout: the wrapper hands the kernel channels-last copies of the videos,
// [B,HD,Tv,H,W,Fp] with Fp >= F zero-padded channels (Fp = VW * ng * np,
// see cuda_lib.channel_layout), and channels-last accumulators of the same
// shape for both video gradients, which it zeroes before and transposes
// back to [B,HD,Tv,F,H,W] after. A pixel's VW channels are then one 8- or
// 16-byte vector: one load, one vector atomic (float2/float4 atomicAdd,
// sm_90, global memory only).
//
// What bounds it on the H100: the global atomics into g_vid1, one per
// (q, k, tap, bilinear corner, VW channels), at data-dependent positions
// in L2. At config 7 (1080p, ps = 1, F = 2 a head) that is 4 float2
// atomics per (q, k) where the first version issued 10 scalar ones, at
// the slice (ps = 3, F = 8) 72 float4 ones plus 1.8 into g_vid0 in place
// of 360 scalar ones. The bytes (videos, positions, cotangents, the
// gradients once) are a few percent of the time. Measured at config 7,
// the vector atomics issue at about the rate the first version's scalar
// ones did (~5e10 a second): the count of atomic instructions, not their
// width, sets the time (PERF.md).
//
// What the design does about it: one thread per (query, group of VW
// channels), the ng groups of a query on neighbouring lanes, walking the
// query's K slots. The thread loads its query patch once for all K (a
// chunk of TC taps at a time) and sums the g_vid0 terms over K in
// registers: with ps = 1 every pixel of g_vid0 belongs to one query
// (stride0 >= 1 puts no two queries on one pixel), so it is written with
// one plain store and is bitwise deterministic; otherwise one vector
// atomic per (query, tap, VW channels) in place of K. The position
// gradients of each (q, k) are summed in registers, reduced over the
// query's lanes with shuffles and written once (added once per further
// tap chunk or channel pass), in a fixed order: deterministic. g_vid1
// depends on the order of the atomics and is not bitwise deterministic.
// Exact skips: corners of bilinear weight 0 (integer positions, the int
// path) add nothing, and neither does an all-zero g_vid0 sum. A shared-
// memory tile of g_vid1 (B4's boxes) measured slower: Hopper's shared
// float adds are compare-and-swap loops (PERF.md).

#include <cuda_runtime.h>

#include "vec_ops.cuh"

namespace {

struct NlsBwdArgs {
  const float* vid0;    // [B,HD,Tv,H,W,Fp] channels-last
  const float* vid1;    // [B,HD,Tv,H,W,Fp]
  const float* prop_h;  // [B,HD,T,nH,nW,K] key positions (integers for int)
  const float* prop_w;
  const int* tj;        // [B,HD,T,nH,nW,K] target frame, -1 for invalid cells
  const float* g_d;     // [B,HD,T,nH,nW,K]
  float* g_vid0;        // [B,HD,Tv,H,W,Fp], zeroed by the caller
  float* g_vid1;        // [B,HD,Tv,H,W,Fp], zeroed by the caller
  float* g_prop_h;      // [B,HD,T,nH,nW,K]
  float* g_prop_w;
  unsigned long long* stats;  // null, or the counts (stnls_nls_topk_bwd)
  int B, HD, T, Fp, H, W, nH, nW, K;
  int Tv, halo;         // video frames, and the frames before the queries
  int ps, stride0, dilation, use_adj, l2, is_int;
  int ng, np;           // lanes (channel groups) a query, channel passes
};

// single reflection, as torch's reflect pad of the plain version reads
__device__ __forceinline__ int reflect_i(int v, int lim) {
  int out = v < 0 ? -v : v;
  out = v > lim - 1 ? 2 * (lim - 1) - v : out;
  return min(max(out, 0), lim - 1);
}

}  // namespace

namespace {

// TC: query taps a thread holds in registers at a time (1 for ps = 1)
template <int VW, int TC>
__global__ void __launch_bounds__(256) nls_topk_bwd_query_kernel(NlsBwdArgs a) {
  const int ng = a.ng;
  const long long n = (long long)a.B * a.HD * a.T * a.nH * a.nW * ng;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  // n is a multiple of ng and ng a power of two up to 32: a query's lanes
  // stay or leave together, and the shuffles below see all of them
  if (i >= n) return;
  const int g = (int)(i % ng);
  const long long q = i / ng;
  const int qw = (int)(q % a.nW);
  long long r = q / a.nW;
  const int qh = (int)(r % a.nH);
  r /= a.nH;
  const int t = (int)(r % a.T);
  const long long bhd = r / a.T;
  const unsigned lane = threadIdx.x & 31u;
  const unsigned seg = ng == 32 ? 0xffffffffu
                                : ((1u << ng) - 1u) << (lane & ~(unsigned)(ng - 1));

  const int H = a.H, W = a.W, dil = a.dilation, ps = a.ps, Fp = a.Fp;
  const long long frame = (long long)H * W * Fp;
  const float* v0 = a.vid0 + (bhd * a.Tv + a.halo + t) * frame;
  float* gv0 = a.g_vid0 + (bhd * a.Tv + a.halo + t) * frame;
  const float* v1b = a.vid1 + bhd * a.Tv * frame;
  float* gv1b = a.g_vid1 + bhd * a.Tv * frame;
  const int po = a.use_adj ? 0 : -(ps / 2);
  const int ref_h = qh * a.stride0 + dil * po, ref_w = qw * a.stride0 + dil * po;
  const int ntaps = ps * ps;
  const long long e0 = q * a.K;
  unsigned n_v1 = 0, n_v0 = 0, n_st = 0, n_pairs = 0;

  for (int pass = 0; pass < a.np; ++pass) {
    const int c0 = (pass * ng + g) * VW;
    for (int tap0 = 0; tap0 < ntaps; tap0 += TC) {
      const bool first = pass == 0 && tap0 == 0;
      float p0[TC][VW], acc[TC][VW];
      int oq[TC], dij[TC];   // query tap pixel; dil * (pi, pj) as pi << 16 | pj
#pragma unroll
      for (int u = 0; u < TC; ++u) {
        oq[u] = 0;
        dij[u] = 0;
#pragma unroll
        for (int c = 0; c < VW; ++c) p0[u][c] = acc[u][c] = 0.f;
        if (tap0 + u < ntaps) {
          const int pi = (tap0 + u) / ps, pj = (tap0 + u) - pi * ps;
          dij[u] = (dil * pi) << 16 | (dil * pj);
          oq[u] = reflect_i(ref_h + dil * pi, H) * W + reflect_i(ref_w + dil * pj, W);
          vload<VW>(p0[u], v0 + (long long)oq[u] * Fp + c0);
        }
      }
      for (int k = 0; k < a.K; ++k) {
        const long long e = e0 + k;
        const float gd = a.g_d[e];
        const int tj = a.tj[e];
        if (tj < 0 || gd == 0.f) {
          if (first && g == 0) {
            a.g_prop_h[e] = 0.f;
            a.g_prop_w[e] = 0.f;
          }
          continue;
        }
        n_pairs += first;
        const float o_h = __fadd_rn(a.prop_h[e], (float)(dil * po));
        const float o_w = __fadd_rn(a.prop_w[e], (float)(dil * po));
        const float fi = floorf(o_h), fj = floorf(o_w);
        const float fh = __fsub_rn(o_h, fi), fw = __fsub_rn(o_w, fj);
        const int i0 = (int)fi, j0 = (int)fj;
        const float w00 = (1.f - fh) * (1.f - fw), w01 = (1.f - fh) * fw;
        const float w10 = fh * (1.f - fw), w11 = fh * fw;
        const float* v1 = v1b + tj * frame + c0;
        float* gv1 = gv1b + tj * frame + c0;
        float gph = 0.f, gpw = 0.f;
#pragma unroll
        for (int u = 0; u < TC; ++u) {
          if (tap0 + u >= ntaps) continue;
          const int di = dij[u] >> 16, dj = dij[u] & 0xffff;
          const long long r0 = reflect_i(i0 + di, H);
          const int cl0 = reflect_i(j0 + dj, W);
          if (a.is_int) {
            const long long o = (r0 * W + cl0) * Fp;
            float p1[VW], gp1[VW];
            vload<VW>(p1, v1 + o);
#pragma unroll
            for (int c = 0; c < VW; ++c) {
              const float gp0 = a.l2 ? 2.f * gd * (p0[u][c] - p1[c]) : gd * p1[c];
              gp1[c] = a.l2 ? -gp0 : gd * p0[u][c];
              acc[u][c] += gp0;
            }
            n_v1 += vatomic<VW>(gv1 + o, gp1);
            continue;
          }
          const long long r1 = reflect_i(i0 + di + 1, H);
          const int cl1 = reflect_i(j0 + dj + 1, W);
          const long long o00 = (r0 * W + cl0) * Fp, o01 = (r0 * W + cl1) * Fp;
          const long long o10 = (r1 * W + cl0) * Fp, o11 = (r1 * W + cl1) * Fp;
          float c00[VW], c01[VW], c10[VW], c11[VW];
          vload<VW>(c00, v1 + o00);
          vload<VW>(c01, v1 + o01);
          vload<VW>(c10, v1 + o10);
          vload<VW>(c11, v1 + o11);
          float a00[VW], a01[VW], a10[VW], a11[VW];
#pragma unroll
          for (int c = 0; c < VW; ++c) {
            const float pv = w00 * c00[c] + w01 * c01[c] + w10 * c10[c] + w11 * c11[c];
            const float gp0 = a.l2 ? 2.f * gd * (p0[u][c] - pv) : gd * pv;
            const float gpv = a.l2 ? -gp0 : gd * p0[u][c];
            acc[u][c] += gp0;
            a00[c] = gpv * w00;
            a01[c] = gpv * w01;
            a10[c] = gpv * w10;
            a11[c] = gpv * w11;
            gph += gpv * ((1.f - fw) * (c10[c] - c00[c]) + fw * (c11[c] - c01[c]));
            gpw += gpv * ((1.f - fh) * (c01[c] - c00[c]) + fh * (c11[c] - c10[c]));
          }
          // a corner of bilinear weight 0 adds nothing
          if (w00 != 0.f) n_v1 += vatomic<VW>(gv1 + o00, a00);
          if (w01 != 0.f) n_v1 += vatomic<VW>(gv1 + o01, a01);
          if (w10 != 0.f) n_v1 += vatomic<VW>(gv1 + o10, a10);
          if (w11 != 0.f) n_v1 += vatomic<VW>(gv1 + o11, a11);
        }
        if (a.is_int) {
          if (first && g == 0) {
            a.g_prop_h[e] = 0.f;
            a.g_prop_w[e] = 0.f;
          }
          continue;
        }
        // the query's lanes hold the same (q, k): sum their channel groups
        for (int off = 1; off < ng; off <<= 1) {
          gph += __shfl_xor_sync(seg, gph, off);
          gpw += __shfl_xor_sync(seg, gpw, off);
        }
        if (g == 0) {
          a.g_prop_h[e] = first ? gph : a.g_prop_h[e] + gph;
          a.g_prop_w[e] = first ? gpw : a.g_prop_w[e] + gpw;
        }
      }
#pragma unroll
      for (int u = 0; u < TC; ++u) {
        if (tap0 + u >= ntaps) continue;
        float* p = gv0 + (long long)oq[u] * Fp + c0;
        if (ps == 1) {   // the pixel's only query: a plain store
          vstore<VW>(p, acc[u]);
          ++n_st;
          continue;
        }
        bool any = false;
#pragma unroll
        for (int c = 0; c < VW; ++c) any |= acc[u][c] != 0.f;
        if (any) n_v0 += vatomic<VW>(p, acc[u]);
      }
    }
  }

  if (a.stats) {
    const unsigned mask = __activemask();
    const unsigned s1 = __reduce_add_sync(mask, n_v1), s0 = __reduce_add_sync(mask, n_v0);
    const unsigned st = __reduce_add_sync(mask, n_st);
    const unsigned sp = __reduce_add_sync(mask, g == 0 ? n_pairs : 0u);
    if ((int)lane == __ffs(mask) - 1) {
      atomicAdd(a.stats + 0, (unsigned long long)s1);
      atomicAdd(a.stats + 1, (unsigned long long)s0);
      atomicAdd(a.stats + 2, (unsigned long long)st);
      atomicAdd(a.stats + 3, (unsigned long long)sp);
    }
  }
}

template <int VW>
int launch(const NlsBwdArgs& a, unsigned blocks, cudaStream_t stream) {
  if (a.ps == 1)
    nls_topk_bwd_query_kernel<VW, 1><<<blocks, 256, 0, stream>>>(a);
  else
    nls_topk_bwd_query_kernel<VW, 9><<<blocks, 256, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success). vw (1, 2 or
// 4), ng (a power of two up to 32) and np give Fp = vw * ng * np channels.
// `stats`, when not null, gets added: [0] the global atomic instructions
// into g_vid1, [1] those into g_vid0, [2] the plain vector stores into
// g_vid0 (ps = 1), [3] the (q, k) pairs with a valid cell and a non-zero
// cotangent.
extern "C" int stnls_nls_topk_bwd(
    const float* vid0, const float* vid1, const float* prop_h,
    const float* prop_w, const int* tj, const float* g_d, float* g_vid0,
    float* g_vid1, float* g_prop_h, float* g_prop_w,
    unsigned long long* stats, int B, int HD, int T, int Fp, int H, int W,
    int nH, int nW, int K, int Tv, int halo, int ps, int stride0,
    int dilation, int use_adj, int l2, int is_int, int vw, int ng, int np,
    void* stream_ptr) {
  NlsBwdArgs a{vid0, vid1, prop_h, prop_w, tj, g_d, g_vid0, g_vid1,
               g_prop_h, g_prop_w, stats, B, HD, T, Fp, H, W, nH, nW, K, Tv,
               halo, ps, stride0, dilation, use_adj, l2, is_int, ng, np};
  if (Fp != vw * ng * np || ng < 1 || ng > 32 || (ng & (ng - 1)) ||
      (vw != 1 && vw != 2 && vw != 4))
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)B * HD * T * nH * nW * ng;
  if (n == 0 || K == 0) return 0;
  const unsigned blocks = (unsigned)((n + 255) / 256);
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  return vw == 4 ? launch<4>(a, blocks, stream)
                 : vw == 2 ? launch<2>(a, blocks, stream) : launch<1>(a, blocks, stream);
}
