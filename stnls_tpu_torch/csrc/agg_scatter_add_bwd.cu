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
// What bounds it on the H100: bytes, then the gathers. At the agg
// example's 128^2 it reads the 3.1 MB cotangent, the video and 12.6 MB of
// weights and offsets and writes a 3.1 MB video gradient and 3.1 MB of
// weight gradients: 0.0075 ms at 3.35 TB/s. But each term gathers a
// pixel's channels of the cotangent at the forward's scattered
// destination: 7.1e6 such gathers for g_w alone (a (query, slot, tap)
// each, whatever the weight), from L1/L2, each warp load touching up to
// 32 lines. The kernel is bound by the latency of those chains.
//
// What the design does about it: one launch, no atomics, deterministic.
// A block takes a tile of 4 x 32 video pixels of one (b, hd, frame). It
// first resolves the centre of every (query, slot) whose taps read the
// tile, its halo of dilation * (ps - 1) rows and columns included, once
// for each frame step, into a table in shared memory (agg_common.cuh:
// the fill test, the rounding, the reflection), reading the weights and
// offsets coalesced; the first design resolved a centre again for each
// of its ps^2 * pt taps and F channels. The cotangent is read from a
// channels-last copy (4 channels a 16-byte load) above a size, else
// planar (ops/agg_sp_cuda.SCATTER_CHANNELS_LAST_MIN). Then:
//   g_vid: two lanes a pixel beyond 4 channels, each taking chunks of 4,
//     walk (pk, pi, pj, k) from the table, skip a zero weight, gather
//     the chunk at each destination and store coalesced rows along x;
//   g_w: the block's threads over (query of the tile, lane), a query's
//     lanes taking its slots in turn: for each tap a lane reads the
//     query side's video channels once (planar, coalesced along qw) and
//     adds their product with each of its slots' cotangent into the
//     slot's sum in shared memory, which only this thread touches.
// Both sum their terms in the first design's order ((pk, pi, pj, k) and
// (pk, pi, pj, c)), so they equal it bitwise. A zero weight adds nothing
// to g_vid but still gets its g_w. Slots beyond what the table holds (kc)
// are taken in chunks; g_vid then adds each chunk into what it wrote.
// Measured and not shipped (PERF.md): one thread a pixel
// for all of g_vid's channels, g_w in a launch of its own, g_w taken 4
// slots at a time in registers.

#include "agg_common.cuh"

namespace {

constexpr int kTileW = 32, kTileH = 4, kPixels = kTileW * kTileH;

struct ScatterBwdArgs {
  const float* vid;      // [B,HD,T,F,H,W]
  const float* weights;  // [B,HD,T,nH,nW,K]
  const float* flows;    // [B,HD,T,nH,nW,K,3] as (dt, dh, dw)
  const float* g_out;    // [B,HD,T,outH,outW,Fp] channels-last, or [B,HD,T,F,outH,outW]
  float* g_vid;          // [B,HD,T,F,H,W]
  float* g_weights;      // [B,HD,T,nH,nW,K]
  int K, T, F, Fp, H, W, nH, nW, outH, outW;
  int ps, strideIn, strideOut, pt, dilation, reflect, use_adj, need_vid, need_weights;
  int rows, cols, kc;    // the table: query rows and columns (at most), slots a chunk
};

// ceil(n / s) for n >= 0, 0 for n < 0
__device__ __forceinline__ int ceil_pos(int n, int s) { return n > 0 ? (n + s - 1) / s : 0; }

// N channels from f0 of the cotangent at destination (nt, sh, sw); gb is
// the (b, hd) block of the cotangent
template <int N, bool CL>
__device__ __forceinline__ void cotangent(float (&v)[N], const ScatterBwdArgs& a,
                                          const float* gb, long long HWo, int nt, int sh,
                                          int sw, int f0) {
  const long long pix = (long long)sh * a.outW + sw;
  if constexpr (CL)
    load_channels<N, true>(v, gb + (nt * HWo + pix) * a.Fp + f0, 1, N);
  else
    load_channels<N, false>(v, gb + ((long long)nt * a.F + f0) * HWo + pix, HWo, a.F - f0);
}

// G: the channels a g_w thread takes at a time (1, 2, 4 or 8). g_vid:
// NL = 2 lanes a pixel beyond 4 channels (else 1), lane l taking the
// chunks l, l + NL, ... of V = min(G, 4) channels. g_w: the threads of
// the block over (query of the tile, lane), a query's lanes taking its
// slots in turn.
template <int G, bool CL, int V = (G < 4 ? G : 4), int NL = (G > 4 ? 2 : 1)>
__global__ void __launch_bounds__(kPixels * NL) agg_scatter_add_bwd_tile_kernel(ScatterBwdArgs a) {
  extern __shared__ int4 table[];                            // [pt][kc][rows][cols]
  float* gw = reinterpret_cast<float*>(table + a.pt * a.kc * a.rows * a.cols);  // [kc][kPixels]
  const int tv = blockIdx.z % a.T;
  const long long bhd = blockIdx.z / a.T;
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  const int lane = threadIdx.x % NL, px = threadIdx.x / NL;
  const int x = x0 + px % kTileW, y = y0 + px / kTileW;
  const int s = a.strideIn, dil = a.dilation;
  const int po = a.use_adj ? 0 : -(a.ps / 2);
  const int dmin = dil * po, dmax = dil * (a.ps - 1 + po);
  // the queries whose taps read the tile: rows r0.., columns c0..
  const int r0 = ceil_pos(y0 - dmax, s), c0 = ceil_pos(x0 - dmax, s);
  const int nr = max(0, min(a.nH - 1, (y0 + kTileH - 1 - dmin) / s) - r0 + 1);
  const int nc = max(0, min(a.nW - 1, (x0 + kTileW - 1 - dmin) / s) - c0 + 1);
  const int npk = min(a.pt, tv + 1);                         // query frames tv - pk >= 0
  // the queries of the tile (g_w): q * strideIn in it; nlw lanes each
  const int or0 = ceil_pos(y0, s), oc0 = ceil_pos(x0, s);
  const int onr = max(0, min(a.nH - 1, (y0 + kTileH - 1) / s) - or0 + 1);
  const int onc = max(0, min(a.nW - 1, (x0 + kTileW - 1) / s) - oc0 + 1);
  const int nown = onr * onc;
  const int nlw = max(1, kPixels * NL / max(nown, 1));
  const int o = threadIdx.x % max(nown, 1), kl = threadIdx.x / max(nown, 1);
  const bool owner = a.need_weights && nown > 0 && kl < nlw;
  const int oqh = or0 + o / max(onc, 1), oqw = oc0 + o % max(onc, 1);

  const long long HWi = (long long)a.H * a.W, HWo = (long long)a.outH * a.outW;
  const bool in_frame = a.need_vid && x < a.W && y < a.H;
  float* gv = a.g_vid + (bhd * a.T + tv) * a.F * HWi + (long long)y * a.W + x;
  const float* gb = a.g_out + bhd * a.T * HWo * (CL ? a.Fp : a.F);

  for (int k0 = 0; k0 < a.K; k0 += a.kc) {
    const int kn = min(a.kc, a.K - k0);
    if (k0) __syncthreads();
    for (int i = threadIdx.x; i < npk * kn * nr * nc; i += kPixels * NL) {
      const int k = i % kn;
      int rest = i / kn;
      const int c = rest % nc;
      rest /= nc;
      const int r = rest % nr, pk = rest / nr;
      const int tq = tv - pk;
      const long long e = (((bhd * a.T + tq) * a.nH + r0 + r) * a.nW + c0 + c) * a.K + k0 + k;
      table[((pk * a.kc + k) * a.rows + r) * a.cols + c] =
          centre_entry(a.weights[e], a.flows + 3 * e, tq, r0 + r, c0 + c, a.strideOut, a.T,
                       a.outH, a.outW);
    }
    __syncthreads();

    // g_vid: this pixel's chunks of V channels, each summed in (pk, pi, pj, k)
    for (int f0 = lane * V; in_frame && f0 < a.F; f0 += NL * V) {
      float acc[V];
#pragma unroll
      for (int c = 0; c < V; ++c) acc[c] = k0 && f0 + c < a.F ? gv[(f0 + c) * HWi] : 0.f;
      for (int pk = 0; pk < npk; ++pk) {
        for (int pi = 0; pi < a.ps; ++pi) {
          const int dh = dil * (pi + po);
          const int yq = y - dh;
          if (yq < 0 || yq % s) continue;
          const int qh = yq / s;
          if (qh >= a.nH) continue;
          for (int pj = 0; pj < a.ps; ++pj) {
            const int dw = dil * (pj + po);
            const int xq = x - dw;
            if (xq < 0 || xq % s) continue;
            const int qw = xq / s;
            if (qw >= a.nW) continue;
            const int4* te = table + ((pk * a.kc) * a.rows + qh - r0) * a.cols + qw - c0;
            for (int k = 0; k < kn; ++k) {
              const int4 e = te[k * a.rows * a.cols];
              const float w = __int_as_float(e.x);
              if (w == 0.f) continue;
              int nt = e.y + pk;
              if (a.reflect) nt = reflect1(nt, a.T);
              const int sh = tap_pos(e.z, dh, a.outH, a.reflect);
              const int sw = tap_pos(e.w, dw, a.outW, a.reflect);
              if (!inb(nt, a.T) || sh < 0 || sw < 0) continue;
              float g[V];
              cotangent<V, CL>(g, a, gb, HWo, nt, sh, sw, f0);
#pragma unroll
              for (int c = 0; c < V; ++c) acc[c] += w * g[c];
            }
          }
        }
      }
#pragma unroll
      for (int c = 0; c < V; ++c)
        if (f0 + c < a.F) gv[(f0 + c) * HWi] = acc[c];
    }

    // g_w of the slots kl, kl + nlw, ... of the query (tv, oqh, oqw), each
    // summed in (pk, pi, pj, c) into its entry of gw, which only this
    // thread touches; the query's entries sit in frame step 0's table
    if (owner) {
      const int4* te = table + (oqh - r0) * a.cols + oqw - c0;
      for (int k = kl; k < kn; k += nlw) gw[k * kPixels + o] = 0.f;
      for (int pk = 0; pk < a.pt && tv + pk < a.T; ++pk) {
        const float* v = a.vid + (bhd * a.T + tv + pk) * a.F * HWi;
        for (int pi = 0; pi < a.ps; ++pi) {
          const int dh = dil * (pi + po);
          const int rh = oqh * s + dh;
          if (!inb(rh, a.H)) continue;
          for (int pj = 0; pj < a.ps; ++pj) {
            const int dw = dil * (pj + po);
            const int rw = oqw * s + dw;
            if (!inb(rw, a.W)) continue;
            for (int f0 = 0; f0 < a.F; f0 += G) {
              float vr[G];
              load_channels<G, false>(vr, v + f0 * HWi + (long long)rh * a.W + rw, HWi,
                                      a.F - f0);
              for (int k = kl; k < kn; k += nlw) {
                const int4 e = te[k * a.rows * a.cols];
                int nt = e.y + pk;
                if (a.reflect) nt = reflect1(nt, a.T);
                const int sh = tap_pos(e.z, dh, a.outH, a.reflect);
                const int sw = tap_pos(e.w, dw, a.outW, a.reflect);
                if (!inb(nt, a.T) || sh < 0 || sw < 0) continue;
                float g[G];
                cotangent<G, CL>(g, a, gb, HWo, nt, sh, sw, f0);
                float sum = gw[k * kPixels + o];
#pragma unroll
                for (int c = 0; c < G; ++c) sum += vr[c] * g[c];
                gw[k * kPixels + o] = sum;
              }
            }
          }
        }
      }
      const long long q = ((bhd * a.T + tv) * a.nH + oqh) * a.nW + oqw;
      for (int k = kl; k < kn; k += nlw) a.g_weights[q * a.K + k0 + k] = gw[k * kPixels + o];
    }
  }
}

template <int G, bool CL>
cudaError_t launch(const ScatterBwdArgs& a, dim3 grid, int smem, cudaStream_t s) {
  auto kernel = agg_scatter_add_bwd_tile_kernel<G, CL>;
  if (smem > (48 << 10)) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err) return err;
  }
  kernel<<<grid, kPixels * (G > 4 ? 2 : 1), smem, s>>>(a);
  return cudaGetLastError();
}

template <bool CL>
cudaError_t dispatch(const ScatterBwdArgs& a, int G, dim3 grid, int smem, cudaStream_t s) {
  if (G == 8) return launch<8, CL>(a, grid, smem, s);
  if (G == 4) return launch<4, CL>(a, grid, smem, s);
  if (G == 2) return launch<2, CL>(a, grid, smem, s);
  return launch<1, CL>(a, grid, smem, s);
}

}  // namespace

// g_vid and g_weights are written where asked (need_vid, need_weights).
// `g_out` is channels-last with Fp channels (cl = 1: Fp = F for F <= 2, 4
// for F <= 4, else a multiple of 8) or planar (cl = 0, Fp = F). The centre
// table takes at most table_bytes of shared memory a block, or one slot's
// where that is more (up to the card's 227 KB). Returns cudaGetLastError()
// after the launch.
extern "C" int stnls_agg_scatter_add_bwd(
    const float* vid, const float* weights, const float* flows,
    const float* g_out, float* g_vid, float* g_weights,
    int B, int HD, int K, int T, int F, int Fp, int H, int W, int nH, int nW,
    int outH, int outW, int ps, int strideIn, int strideOut, int pt,
    int dilation, int reflect, int use_adj, int need_vid, int need_weights,
    int cl, int table_bytes, void* stream_ptr) {
  const int G = channel_group(F, Fp, cl);
  if (Fp < F || (!cl && Fp != F) || (cl && Fp % G)) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long n_vid = (long long)B * HD * T * F * H * W;
  const long long n_w = (long long)B * HD * T * nH * nW * K;
  if (K == 0 || F == 0) {          // g_vid is 0; so is g_w (no channel)
    if (need_vid && n_vid) cudaMemsetAsync(g_vid, 0, n_vid * sizeof(float), stream);
    if (need_weights && n_w) cudaMemsetAsync(g_weights, 0, n_w * sizeof(float), stream);
    return (int)cudaGetLastError();
  }
  if (!(need_vid && n_vid) && !(need_weights && n_w)) return 0;
  const int dspan = dilation * (ps - 1);
  const int rows = (kTileH - 1 + dspan) / strideIn + 1;
  const int cols = (kTileW - 1 + dspan) / strideIn + 1;
  const long long slot = (long long)pt * rows * cols * sizeof(int4) + kPixels * sizeof(float);
  const int kc = (int)max(1LL, min((long long)K, table_bytes / slot));
  const long long smem = kc * slot;
  if (smem > (227 << 10)) return (int)cudaErrorInvalidValue;
  if ((long long)B * HD * T > 65535) return (int)cudaErrorInvalidConfiguration;
  ScatterBwdArgs a{vid, weights, flows, g_out, g_vid, g_weights, K, T, F, Fp, H, W, nH, nW,
                   outH, outW, ps, strideIn, strideOut, pt, dilation, reflect, use_adj,
                   need_vid, need_weights, rows, cols, kc};
  const dim3 grid((unsigned)((W + kTileW - 1) / kTileW), (unsigned)((H + kTileH - 1) / kTileH),
                  (unsigned)(B * HD * T));
  return (int)(cl ? dispatch<true>(a, G, grid, (int)smem, stream)
                  : dispatch<false>(a, G, grid, (int)smem, stream));
}
