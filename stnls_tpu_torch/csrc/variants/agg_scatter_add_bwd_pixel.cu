// A variant of B8 (stnls_tpu_torch/csrc/agg_scatter_add_bwd.cu) that the
// port does not build; stnls_tpu_torch/b8_b9_variants.py times it against
// the shipped kernel. The shipped tile and centre table, with one thread
// a pixel taking a group of G <= 8 channels for g_vid (one or two 16-byte
// loads a term from a channels-last cotangent), and one thread a query of
// the tile for g_w: it reads the query side's video channels of a tap
// once and adds their product with each slot's cotangent into the slot's
// sum in shared memory. Both in the first design's summation order. Same
// C interface as the shipped entry.

#include "agg_common.cuh"

namespace {

constexpr int kTileW = 32, kTileH = 4, kThreads = kTileW * kTileH;

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

// a.ceil(n / s) for n >= 0, 0 for n < 0
__device__ __forceinline__ int ceil_pos(int n, int s) { return n > 0 ? (n + s - 1) / s : 0; }

template <int G, bool CL>
__global__ void __launch_bounds__(kThreads) agg_scatter_add_bwd_tile_kernel(ScatterBwdArgs a) {
  extern __shared__ int4 smem[];
  int4* table = smem;                                        // [pt][kc][rows][cols]
  float* gw = reinterpret_cast<float*>(table + a.pt * a.kc * a.rows * a.cols);  // [kc][kThreads]
  const int tv = blockIdx.z % a.T;
  const long long bhd = blockIdx.z / a.T;
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  const int x = x0 + threadIdx.x % kTileW, y = y0 + threadIdx.x / kTileW;
  const int s = a.strideIn, dil = a.dilation;
  const int po = a.use_adj ? 0 : -(a.ps / 2);
  const int dmin = dil * po, dmax = dil * (a.ps - 1 + po);
  // the queries whose taps read the tile: rows r0.., columns c0..
  const int r0 = ceil_pos(y0 - dmax, s), c0 = ceil_pos(x0 - dmax, s);
  const int nr = max(0, min(a.nH - 1, (y0 + kTileH - 1 - dmin) / s) - r0 + 1);
  const int nc = max(0, min(a.nW - 1, (x0 + kTileW - 1 - dmin) / s) - c0 + 1);
  const int npk = min(a.pt, tv + 1);                         // query frames tv - pk >= 0
  // the queries of the tile (g_w): q * strideIn in it
  const int or0 = ceil_pos(y0, s), oc0 = ceil_pos(x0, s);
  const int onr = max(0, min(a.nH - 1, (y0 + kTileH - 1) / s) - or0 + 1);
  const int onc = max(0, min(a.nW - 1, (x0 + kTileW - 1) / s) - oc0 + 1);
  const int o = threadIdx.x;
  const bool owner = a.need_weights && o < onr * onc;
  const int oqh = or0 + (owner ? o / onc : 0), oqw = oc0 + (owner ? o % onc : 0);

  const long long HWi = (long long)a.H * a.W, HWo = (long long)a.outH * a.outW;
  const bool in_frame = a.need_vid && x < a.W && y < a.H;
  float* gv = a.g_vid + (bhd * a.T + tv) * a.F * HWi + (long long)y * a.W + x;
  const float* gb = a.g_out + bhd * a.T * HWo * (CL ? a.Fp : a.F);
  // the G channels of the cotangent at destination (nt, sh, sw)
  auto cotangent = [&](float (&v)[G], int nt, int sh, int sw, int f0) {
    const long long pix = (long long)sh * a.outW + sw;
    if constexpr (CL)
      load_channels<G, true>(v, gb + (nt * HWo + pix) * a.Fp + f0, 1, G);
    else
      load_channels<G, false>(v, gb + ((long long)nt * a.F + f0) * HWo + pix, HWo, a.F - f0);
  };

  for (int k0 = 0; k0 < a.K; k0 += a.kc) {
    const int kn = min(a.kc, a.K - k0);
    if (k0) __syncthreads();
    for (int i = threadIdx.x; i < npk * kn * nr * nc; i += kThreads) {
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

    if (in_frame) {
      for (int f0 = 0; f0 < a.F; f0 += G) {
        float acc[G];
#pragma unroll
        for (int c = 0; c < G; ++c) acc[c] = k0 && f0 + c < a.F ? gv[(f0 + c) * HWi] : 0.f;
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
                float g[G];
                cotangent(g, nt, sh, sw, f0);
#pragma unroll
                for (int c = 0; c < G; ++c) acc[c] += w * g[c];
              }
            }
          }
        }
#pragma unroll
        for (int c = 0; c < G; ++c)
          if (f0 + c < a.F) gv[(f0 + c) * HWi] = acc[c];
      }
    }

    if (owner) {
      // the query (tv, oqh, oqw): its entries sit in frame step 0's table
      const int4* te = table + (oqh - r0) * a.cols + oqw - c0;
      for (int k = 0; k < kn; ++k) gw[k * kThreads + o] = 0.f;
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
              for (int k = 0; k < kn; ++k) {
                const int4 e = te[k * a.rows * a.cols];
                int nt = e.y + pk;
                if (a.reflect) nt = reflect1(nt, a.T);
                const int sh = tap_pos(e.z, dh, a.outH, a.reflect);
                const int sw = tap_pos(e.w, dw, a.outW, a.reflect);
                if (!inb(nt, a.T) || sh < 0 || sw < 0) continue;
                float g[G];
                cotangent(g, nt, sh, sw, f0);
                float sum = gw[k * kThreads + o];
#pragma unroll
                for (int c = 0; c < G; ++c) sum += vr[c] * g[c];
                gw[k * kThreads + o] = sum;
              }
            }
          }
        }
      }
      const long long q = ((bhd * a.T + tv) * a.nH + oqh) * a.nW + oqw;
      for (int k = 0; k < kn; ++k) a.g_weights[q * a.K + k0 + k] = gw[k * kThreads + o];
    }
  }
}

template <bool CL>
void launch(const ScatterBwdArgs& a, int G, dim3 grid, size_t smem, cudaStream_t s) {
  if (G == 8) agg_scatter_add_bwd_tile_kernel<8, CL><<<grid, kThreads, smem, s>>>(a);
  else if (G == 4) agg_scatter_add_bwd_tile_kernel<4, CL><<<grid, kThreads, smem, s>>>(a);
  else if (G == 2) agg_scatter_add_bwd_tile_kernel<2, CL><<<grid, kThreads, smem, s>>>(a);
  else agg_scatter_add_bwd_tile_kernel<1, CL><<<grid, kThreads, smem, s>>>(a);
}

template <bool CL>
cudaError_t allow_smem(int G, int bytes) {
  if (G == 8) return cudaFuncSetAttribute(agg_scatter_add_bwd_tile_kernel<8, CL>,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (G == 4) return cudaFuncSetAttribute(agg_scatter_add_bwd_tile_kernel<4, CL>,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (G == 2) return cudaFuncSetAttribute(agg_scatter_add_bwd_tile_kernel<2, CL>,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  return cudaFuncSetAttribute(agg_scatter_add_bwd_tile_kernel<1, CL>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
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
  const long long slot = (long long)pt * rows * cols * sizeof(int4) + kThreads * sizeof(float);
  const int kc = (int)max(1LL, min((long long)K, table_bytes / slot));
  const long long smem = kc * slot;
  if (smem > (227 << 10)) return (int)cudaErrorInvalidValue;
  if ((long long)B * HD * T > 65535) return (int)cudaErrorInvalidConfiguration;
  if (smem > (48 << 10)) {
    const cudaError_t err = cl ? allow_smem<true>(G, (int)smem) : allow_smem<false>(G, (int)smem);
    if (err) return (int)err;
  }
  ScatterBwdArgs a{vid, weights, flows, g_out, g_vid, g_weights, K, T, F, Fp, H, W, nH, nW,
                   outH, outW, ps, strideIn, strideOut, pt, dilation, reflect, use_adj,
                   need_vid, need_weights, rows, cols, kc};
  const dim3 grid((unsigned)((W + kTileW - 1) / kTileW), (unsigned)((H + kTileH - 1) / kTileH),
                  (unsigned)(B * HD * T));
  if (cl) launch<true>(a, G, grid, (size_t)smem, stream);
  else launch<false>(a, G, grid, (size_t)smem, stream);
  return (int)cudaGetLastError();
}
