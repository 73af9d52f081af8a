// A variant of B2 (stnls_tpu_torch/csrc/nls_topk_bwd.cu) for measurement
// only: stnls_tpu_torch/b2_b3_variants.py builds it into a library of its
// own and times it against the shipped kernel in turns. The port does not
// build or call it.
//
// The shipped design, with g_vid1 accumulated as B4 (csrc/agg_gather_bwd.cu)
// accumulates its video gradient: one block takes a tile of queries of one
// (b, hd, t) (ng lanes a query, 256 lanes a block: 16 rows of 256 / ng / 16
// queries); sweep 1 reduces, per key frame, the bounding box of the
// bilinear corners its active (q, k) reach (shared atomicMin/Max); the boxes
// that fit a 96 KB pool hold all Fp channels of their pixels; the adds of
// the main sweep go into them with shared float atomics (one per channel:
// there is no vector shared atomic), a frame without a box takes the
// shipped vector global atomics; the flush adds each box pixel's non-zero
// channels to g_vid1 with one vector global atomic. Takes ng <= 16.

#include <limits.h>

#include "nls_topk_bwd.cuh"

namespace {

constexpr int TQH = 16, NT = 256;
constexpr int POOL_FLOATS = 24576;   // 96 KB

struct Box {
  int r0, r1, c0, c1, base;
};

__device__ __forceinline__ int box_area(const Box& b) {
  return b.r1 < b.r0 ? 0 : (b.r1 - b.r0 + 1) * (b.c1 - b.c0 + 1);
}

template <int VW, int TC>
__global__ void __launch_bounds__(NT) nls_topk_bwd_tile_kernel(NlsBwdArgs a) {
  extern __shared__ float smem[];
  float* pool = smem;
  Box* box = reinterpret_cast<Box*>(smem + POOL_FLOATS);
  unsigned long long* cnt_s = reinterpret_cast<unsigned long long*>(
      (reinterpret_cast<size_t>(box + a.Tv) + 7) & ~size_t(7));
  const int ng = a.ng, tqw = NT / ng / TQH;
  const int tid = threadIdx.x, g = tid % ng, ql = tid / ng;
  const int qh = blockIdx.y * TQH + ql / tqw, qw = blockIdx.x * tqw + ql % tqw;
  const int t = blockIdx.z % a.T;
  const long long bhd = blockIdx.z / a.T;
  const bool active = qh < a.nH && qw < a.nW;
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
  const long long e0 = (((bhd * a.T + t) * a.nH + qh) * (long long)a.nW + qw) * a.K;

  for (int i = tid; i < a.Tv; i += NT) box[i] = Box{INT_MAX, INT_MIN, INT_MAX, INT_MIN, -1};
  if (tid < 4) cnt_s[tid] = 0;
  __syncthreads();
  // sweep 1: the boxes of the key frames
  if (active && g == 0) {
    for (int k = 0; k < a.K; ++k) {
      const long long e = e0 + k;
      const int tj = a.tj[e];
      if (tj < 0 || a.g_d[e] == 0.f) continue;
      const int i0 = (int)floorf(__fadd_rn(a.prop_h[e], (float)(dil * po)));
      const int j0 = (int)floorf(__fadd_rn(a.prop_w[e], (float)(dil * po)));
      int r_lo = INT_MAX, r_hi = INT_MIN, c_lo = INT_MAX, c_hi = INT_MIN;
      for (int p = 0; p < ps; ++p) {
        const int ra = reflect_i(i0 + dil * p, H), rb = a.is_int ? ra : reflect_i(i0 + dil * p + 1, H);
        const int ca = reflect_i(j0 + dil * p, W), cb = a.is_int ? ca : reflect_i(j0 + dil * p + 1, W);
        r_lo = min(r_lo, min(ra, rb));
        r_hi = max(r_hi, max(ra, rb));
        c_lo = min(c_lo, min(ca, cb));
        c_hi = max(c_hi, max(ca, cb));
      }
      atomicMin(&box[tj].r0, r_lo);
      atomicMax(&box[tj].r1, r_hi);
      atomicMin(&box[tj].c0, c_lo);
      atomicMax(&box[tj].c1, c_hi);
    }
  }
  __syncthreads();
  if (tid == 0) {
    int off = 0;
    for (int f = 0; f < a.Tv; ++f) {
      const int need = box_area(box[f]) * Fp;
      if (need > 0 && off + need <= POOL_FLOATS) {
        box[f].base = off;
        off += need;
      }
    }
  }
  __syncthreads();
  for (int f = 0; f < a.Tv; ++f) {
    if (box[f].base < 0) continue;
    const int n = box_area(box[f]) * Fp;
    for (int i = tid; i < n; i += NT) pool[box[f].base + i] = 0.f;
  }
  __syncthreads();

  unsigned n_v1 = 0, n_v0 = 0, n_st = 0, n_pairs = 0;
  if (active) {
    for (int pass = 0; pass < a.np; ++pass) {
      const int c0 = (pass * ng + g) * VW;
      for (int tap0 = 0; tap0 < ntaps; tap0 += TC) {
        const bool first = pass == 0 && tap0 == 0;
        float p0[TC][VW], acc[TC][VW];
        int oq[TC], dij[TC];
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
          const Box bx = box[tj];
          const int bw = bx.c1 - bx.c0 + 1;
          float* sb = pool + max(bx.base, 0) + c0;
          float gph = 0.f, gpw = 0.f;
#pragma unroll
          for (int u = 0; u < TC; ++u) {
            if (tap0 + u >= ntaps) continue;
            const int di = dij[u] >> 16, dj = dij[u] & 0xffff;
            const int r0 = reflect_i(i0 + di, H), cl0 = reflect_i(j0 + dj, W);
            const int r1 = a.is_int ? r0 : reflect_i(i0 + di + 1, H);
            const int cl1 = a.is_int ? cl0 : reflect_i(j0 + dj + 1, W);
            const int rr[4] = {r0, r0, r1, r1}, cc[4] = {cl0, cl1, cl0, cl1};
            const float cw[4] = {w00, w01, w10, w11};
            float cv[4][VW], add[4][VW];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              if (a.is_int && j > 0) break;
              vload<VW>(cv[j], v1 + ((long long)rr[j] * W + cc[j]) * Fp);
            }
#pragma unroll
            for (int c = 0; c < VW; ++c) {
              const float pv = a.is_int ? cv[0][c]
                  : w00 * cv[0][c] + w01 * cv[1][c] + w10 * cv[2][c] + w11 * cv[3][c];
              const float gp0 = a.l2 ? 2.f * gd * (p0[u][c] - pv) : gd * pv;
              const float gpv = a.l2 ? -gp0 : gd * p0[u][c];
              acc[u][c] += gp0;
              if (a.is_int) {
                add[0][c] = gpv;
                continue;
              }
#pragma unroll
              for (int j = 0; j < 4; ++j) add[j][c] = gpv * cw[j];
              gph += gpv * ((1.f - fw) * (cv[2][c] - cv[0][c]) + fw * (cv[3][c] - cv[1][c]));
              gpw += gpv * ((1.f - fh) * (cv[1][c] - cv[0][c]) + fh * (cv[3][c] - cv[2][c]));
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              if (a.is_int && j > 0) break;
              if (!a.is_int && cw[j] == 0.f) continue;
              if (bx.base >= 0) {
                float* p = sb + ((rr[j] - bx.r0) * bw + (cc[j] - bx.c0)) * Fp;
#pragma unroll
                for (int c = 0; c < VW; ++c)
                  if (add[j][c] != 0.f) atomicAdd(p + c, add[j][c]);
              } else {
                n_v1 += vatomic<VW>(gv1 + ((long long)rr[j] * W + cc[j]) * Fp, add[j]);
              }
            }
          }
          if (a.is_int) {
            if (first && g == 0) {
              a.g_prop_h[e] = 0.f;
              a.g_prop_w[e] = 0.f;
            }
            continue;
          }
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
          if (ps == 1) {
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
  }
  __syncthreads();
  // flush: each box pixel's non-zero channel vectors once into g_vid1
  for (int f = 0; f < a.Tv; ++f) {
    const Box bx = box[f];
    if (bx.base < 0) continue;
    const int bw = bx.c1 - bx.c0 + 1, nv = box_area(bx) * (Fp / VW);
    float* gv1 = gv1b + f * frame;
    for (int i = tid; i < nv; i += NT) {
      const int px = i / (Fp / VW), cv = (i - px * (Fp / VW)) * VW;
      float x[VW];
      bool any = false;
#pragma unroll
      for (int c = 0; c < VW; ++c) {
        x[c] = pool[bx.base + px * Fp + cv + c];
        any |= x[c] != 0.f;
      }
      if (!any) continue;
      const long long r = bx.r0 + px / bw, c = bx.c0 + px % bw;
      n_v1 += vatomic<VW>(gv1 + (r * W + c) * Fp + cv, x);
    }
  }
  if (a.stats) {
    atomicAdd(cnt_s + 0, (unsigned long long)n_v1);
    atomicAdd(cnt_s + 1, (unsigned long long)n_v0);
    atomicAdd(cnt_s + 2, (unsigned long long)n_st);
    atomicAdd(cnt_s + 3, (unsigned long long)(g == 0 ? n_pairs : 0u));
    __syncthreads();
    if (tid < 4) atomicAdd(a.stats + tid, cnt_s[tid]);
  }
}

template <int VW>
int launch(const NlsBwdArgs& a, cudaStream_t stream) {
  const int tqw = NT / a.ng / TQH;
  const dim3 grid((a.nW + tqw - 1) / tqw, (a.nH + TQH - 1) / TQH, a.B * a.HD * a.T);
  const size_t smem = POOL_FLOATS * sizeof(float) + (size_t)(a.Tv + 1) * sizeof(Box) +
                      4 * sizeof(unsigned long long);
  cudaError_t err;
  if (a.ps == 1) {
    err = cudaFuncSetAttribute(nls_topk_bwd_tile_kernel<VW, 1>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    nls_topk_bwd_tile_kernel<VW, 1><<<grid, NT, smem, stream>>>(a);
  } else {
    err = cudaFuncSetAttribute(nls_topk_bwd_tile_kernel<VW, 9>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    nls_topk_bwd_tile_kernel<VW, 9><<<grid, NT, smem, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The shipped kernel's C interface.
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
  if (Fp != vw * ng * np || ng < 1 || ng > 16 || (ng & (ng - 1)) ||
      (vw != 1 && vw != 2 && vw != 4) || (long long)B * HD * T > 65535)
    return (int)cudaErrorInvalidValue;
  if ((long long)B * HD * T * nH * nW == 0 || K == 0) return 0;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  return vw == 4 ? launch<4>(a, stream) : vw == 2 ? launch<2>(a, stream) : launch<1>(a, stream);
}
