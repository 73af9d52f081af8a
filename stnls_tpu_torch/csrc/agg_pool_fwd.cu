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
// at most one (query, tap); the plain version divides it by that count +
// 1e-10, which is 1.0f in float32 (a pixel no tap reaches is 0).
//
// What bounds it on the H100: bytes, then the gathers. At the agg
// example's 128^2 it writes a 28 MB output (ps^2 = 9 times the video) and
// reads 12.6 MB of weights and offsets and the 3.1 MB video: 0.013 ms at
// 3.35 TB/s. Each output element gathers one pixel's channel for each of
// its K slots from L1/L2 at a scattered centre.
//
// What the design does about it: one block a (b, hd, t, query row) and
// 128 output columns, a thread a column. The block first resolves the
// centre of each (query, slot) of its columns once (the weight test, the
// rounding, the reflection) into a table in shared memory, reading the
// weights and offsets coalesced; the first design resolved it again in
// each of the ps^2 * F threads of a query. Each thread then walks its
// ps output rows: for each (frame step, slot) it reads the table entry,
// gathers a group of G <= 8 channels of the video pixel from the planar
// video and stores one coalesced row along x in each channel plane, the
// pixels no tap reaches included (0). Each output is written once and
// sums its terms in the first design's order (pk, then k), so it equals
// the first design bitwise; no atomics. Slots beyond what the table holds
// (kc) are taken in chunks, each adding into the output row it wrote.
// A channels-last copy of the video was no faster on the device at the agg example's 128^2 and slower at
// 512^2, the copy included, and faster only on a small, densely weighted
// case (PERF.md): most slots of the agg example carry a weight below
// 1e-8, so the stores, not the gathers, take the time.

#include "agg_common.cuh"

namespace {

constexpr int kCols = 128;   // output columns a block, a thread each

struct PoolArgs {
  const float* vid;      // [B,HD,T,F,H,W]
  const float* weights;  // [B,HD,T,nH,nW,K]
  const float* flows;    // [B,HD,T,nH,nW,K,3] as (dt, dh, dw)
  float* out;            // [B,HD,T,F,ps*nH,ps*nW]
  int K, T, F, H, W, nH, nW;
  int ps, stride0, pt, dilation, reflect, use_adj;
  int span, kc;          // the table: queries a block (at most), slots a chunk
};

template <int G>
__global__ void __launch_bounds__(kCols) agg_pool_fwd_row_kernel(PoolArgs a) {
  extern __shared__ int4 table[];           // [kc][span]
  const int ps = a.ps, outH = ps * a.nH, outW = ps * a.nW;
  const int po = a.use_adj ? 0 : -(ps / 2);
  const int base = (ps - 1) / 2 + 1 + po;   // psHalf + patch_offset, 1 .. ps
  const int qh = blockIdx.y;
  const int bt = blockIdx.z;                // (b, hd, t)
  const int t = bt % a.T;
  const long long bhd = bt / a.T;
  const int x0 = blockIdx.x * kCols, x = x0 + threadIdx.x;
  const bool live = x < outW;
  const bool owned = live && x >= base;     // columns below base: no tap
  const int qw = owned ? (x - base) / ps : 0;
  const int pj = owned ? x - base - qw * ps : 0;
  // the block's queries along the row: q0 .. q0 + nq - 1
  const int x1 = min(x0 + kCols, outW) - 1;
  const int q0 = max(x0 - base, 0) / ps;
  const int nq = x1 >= base ? (x1 - base) / ps - q0 + 1 : 0;

  const long long HW = (long long)a.H * a.W, HWo = (long long)outH * outW;
  float* orow = a.out + (long long)bt * a.F * HWo + x;
  if (qh == 0 && live) {                    // rows below base: no tap
    for (int y = 0; y < base; ++y)
      for (int c = 0; c < a.F; ++c) orow[c * HWo + (long long)y * outW] = 0.f;
  }
  const float* vb = a.vid + bhd * a.T * a.F * HW;
  const long long qrow = ((long long)bt * a.nH + qh) * a.nW;
  const int dw = a.dilation * (pj + po);

  for (int k0 = 0; k0 < a.K; k0 += a.kc) {
    const int kn = min(a.kc, a.K - k0);
    if (k0) __syncthreads();
    for (int i = threadIdx.x; i < nq * kn; i += kCols) {
      const int k = i % kn, j = i / kn;
      const long long e = (qrow + q0 + j) * a.K + k0 + k;
      const float w = a.weights[e];
      int4 c = centre_entry(w, a.flows + 3 * e, t, qh, q0 + j, a.stride0, a.T, a.H,
                            a.W);
      if (w < 1e-8f || c.y == kDropped) c.x = 0;   // the weight 0: skipped
      table[k * a.span + j] = c;
    }
    __syncthreads();
    if (!live) continue;
    for (int pi = 0; pi < ps; ++pi) {
      const int y = qh * ps + base + pi;
      if (y >= outH) break;
      const int dh = a.dilation * (pi + po);
      float* o = orow + (long long)y * outW;
      for (int f0 = 0; f0 < a.F; f0 += G) {
        float acc[G];
#pragma unroll
        for (int c = 0; c < G; ++c) acc[c] = k0 && f0 + c < a.F ? o[(f0 + c) * HWo] : 0.f;
        if (owned) {
          for (int pk = 0; pk < a.pt; ++pk) {
            for (int k = 0; k < kn; ++k) {
              const int4 e = table[k * a.span + qw - q0];
              const float w = __int_as_float(e.x);
              if (w == 0.f) continue;
              const int nt = reflect1(e.y + pk, a.T);
              const int ph = tap_pos(e.z, dh, a.H, a.reflect);
              const int pw = tap_pos(e.w, dw, a.W, a.reflect);
              if (!inb(nt, a.T) || ph < 0 || pw < 0) continue;
              const long long pix = (long long)ph * a.W + pw;
              float v[G];
              load_channels<G, false>(v, vb + ((long long)nt * a.F + f0) * HW + pix, HW,
                                      a.F - f0);
#pragma unroll
              for (int c = 0; c < G; ++c) acc[c] += w * v[c];
            }
          }
        }
#pragma unroll
        for (int c = 0; c < G; ++c)
          if (f0 + c < a.F) o[(f0 + c) * HWo] = acc[c];
      }
    }
  }
}

void launch(const PoolArgs& a, int G, dim3 grid, size_t smem, cudaStream_t s) {
  if (G == 8) agg_pool_fwd_row_kernel<8><<<grid, kCols, smem, s>>>(a);
  else if (G == 4) agg_pool_fwd_row_kernel<4><<<grid, kCols, smem, s>>>(a);
  else if (G == 2) agg_pool_fwd_row_kernel<2><<<grid, kCols, smem, s>>>(a);
  else agg_pool_fwd_row_kernel<1><<<grid, kCols, smem, s>>>(a);
}

}  // namespace

// ps must be odd. The centre table takes at most table_bytes of shared
// memory a block (at least one slot's). Returns cudaGetLastError() after
// the launch.
extern "C" int stnls_agg_pool_fwd(
    const float* vid, const float* weights, const float* flows, float* out,
    int B, int HD, int K, int T, int F, int H, int W, int nH, int nW, int ps,
    int stride0, int pt, int dilation, int reflect, int use_adj, int table_bytes,
    void* stream_ptr) {
  const int G = channel_group(F, F, 0);
  if (ps % 2 == 0) return (int)cudaErrorInvalidValue;
  const long long n = (long long)B * HD * T * F * (ps * nH) * (ps * nW);
  if (n == 0 || K == 0) {
    if (n) cudaMemsetAsync(out, 0, n * sizeof(float), static_cast<cudaStream_t>(stream_ptr));
    return (int)cudaGetLastError();
  }
  const int span = kCols / ps + 2;
  const int slot = span * (int)sizeof(int4);      // <= 48 KB needs no opt-in
  const int kc = max(1, min(K, min(table_bytes, 48 << 10) / slot));
  if (nH > 65535 || (long long)B * HD * T > 65535) return (int)cudaErrorInvalidConfiguration;
  PoolArgs a{vid, weights, flows, out, K, T, F, H, W, nH, nW, ps, stride0,
             pt, dilation, reflect, use_adj, span, kc};
  const dim3 grid((unsigned)((ps * nW + kCols - 1) / kCols), (unsigned)nH,
                  (unsigned)(B * HD * T));
  const cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  launch(a, G, grid, (size_t)kc * slot, s);
  return (int)cudaGetLastError();
}
