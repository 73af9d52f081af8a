// A variant of B6 (stnls_tpu_torch/csrc/nls_vol_bwd.cu) for measurement
// only: stnls_tpu_torch/b5_b6_variants.py builds it into a library of its
// own and times it against the shipped kernel in turns. The port does not
// build or call it. It was measured slower than the shipped kernel in
// every case timed (PERF.md).
//
// The shipped design (one thread per (query, slot, vector of VW
// channels) over channels-last videos, consecutive cells' corner columns
// merged in registers), with g_vid1 accumulated in a private box per
// thread: E x E pixels x VW channels of the key region in shared memory,
// E = floor((ws - 1) * stride1) + dilation * (ps - 1) + 3
// (b5_b6_variants.box_extent, capped to what fits b5_b6_variants.BOX_SMEM
// and passed as `box`), placed at the slot's first lattice position plus
// the first tap's offset, so that every unreflected corner falls inside.
// A column is added there with a plain shared load/add/store (the box is
// the thread's own: no shared atomics, which Hopper compiles to
// compare-and-swap loops; laid out thread-minor, no bank conflicts), a
// corner outside (a reflected tap, a capped box) with a global atomic,
// and the box's non-zero vectors are flushed once. A slot whose active
// cells add fewer corners than the box holds takes the global atomics
// directly (box when active * ps^2 * (4 float, 1 int) > E^2).

#include <cuda_runtime.h>
#include <limits.h>

#include "nls_common.cuh"
#include "vec_ops.cuh"

namespace {

// VW floats at byte address `addr` of the block's shared memory, as
// ld.shared / st.shared: the state space is explicit, so the compiler
// neither takes them for global accesses nor orders global loads after
// them (volatile keeps them in program order among themselves)
template <int VW>
__device__ __forceinline__ void sload(float* x, unsigned addr) {
  if constexpr (VW == 4) {
    asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
                 : "=f"(x[0]), "=f"(x[1]), "=f"(x[2]), "=f"(x[3]) : "r"(addr));
  } else if constexpr (VW == 2) {
    asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];"
                 : "=f"(x[0]), "=f"(x[1]) : "r"(addr));
  } else {
    asm volatile("ld.shared.f32 %0, [%1];" : "=f"(x[0]) : "r"(addr));
  }
}

template <int VW>
__device__ __forceinline__ void sstore(unsigned addr, const float* x) {
  if constexpr (VW == 4) {
    asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};"
                 :: "r"(addr), "f"(x[0]), "f"(x[1]), "f"(x[2]), "f"(x[3]));
  } else if constexpr (VW == 2) {
    asm volatile("st.shared.v2.f32 [%0], {%1, %2};"
                 :: "r"(addr), "f"(x[0]), "f"(x[1]));
  } else {
    asm volatile("st.shared.f32 [%0], %1;" :: "r"(addr), "f"(x[0]));
  }
}

struct VolBwdArgs {
  const float* vid0;   // [B,HD,Tv,H,W,Fp] channels-last, channels >= F zero
  const float* vid1;   // [B,HD,Tv,H,W,Fp]
  const float* ctr_h;  // [B,HD,T,W_t,nH,nW] reflected centres (integers for int)
  const float* ctr_w;
  const float* g_d;    // [B,HD,T,W_t,ws,ws,nH,nW]
  float* g_vid0;       // [B,HD,Tv,H,W,Fp], zeroed by the caller
  float* g_vid1;       // [B,HD,Tv,H,W,Fp], zeroed by the caller
  float* g_ctr_h;      // [B,HD,T,W_t,nH,nW]
  float* g_ctr_w;
  unsigned long long* stats;  // null, or the counts (stnls_nls_vol_bwd)
  int B, HD, T, Fp, H, W, nH, nW, W_t;
  int Tv, t0, Tg, halo;  // video frames and the chunk (nls_common.cuh)
  int ws, wt, ps, stride0, dilation;
  float stride1;       // float path; the int path passes max(1, int(stride1))
  float s1_half;       // stride1 * ((ws-1)/2), rounded once on the host
  int l2, full_ws, use_adj, is_int;
  int ng, np;          // lanes (channel vectors) a (query, slot), passes
  int box;             // the box extent E
};

constexpr int kBoxThreads = 128;   // threads a block

template <int VW>
__global__ void __launch_bounds__(kBoxThreads, 1)
    nls_vol_bwd_box_kernel(VolBwdArgs a) {
  extern __shared__ float4 smem[];   // the boxes
  const int ng = a.ng;
  const long long n = (long long)a.B * a.HD * a.T * a.W_t * a.nH * a.nW * ng;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  // n is a multiple of ng and ng a power of two up to 32: a (query,
  // slot)'s lanes stay or leave together, and the shuffles see all of them
  if (i >= n) return;
  const int g = (int)(i % ng);
  const long long qs = i / ng;
  const int qw = (int)(qs % a.nW);
  long long r = qs / a.nW;
  const int qh = (int)(r % a.nH);
  r /= a.nH;
  const int st = (int)(r % a.W_t);
  const long long bhdt = r / a.W_t;         // (b * HD + hd) * T + t
  const int t = (int)(bhdt % a.T);
  const long long bhd = bhdt / a.T;
  const unsigned lane = threadIdx.x & 31u;
  const unsigned seg = ng == 32 ? 0xffffffffu
                                : ((1u << ng) - 1u) << (lane & ~(unsigned)(ng - 1));

  const int H = a.H, W = a.W, ws = a.ws, dil = a.dilation, ps = a.ps;
  const int Fp = a.Fp;
  const bool l2 = a.l2, is_int = a.is_int;
  const long long plane = (long long)a.nH * a.nW;
  const long long frame = (long long)H * W * Fp;
  const int ref_h = (qh * a.stride0) % H;
  const int ref_w = (qw * a.stride0) % W;
  const int po = a.use_adj ? 0 : -(ps / 2);
  const float s1 = a.stride1;

  const long long c = (bhdt * a.W_t + st) * plane + (long long)qh * a.nW + qw;
  const float ch = a.ctr_h[c], cw = a.ctr_w[c];
  float oh, ow;
  window_offsets(a, ch, cw, &oh, &ow);
  const int tj = chunk_window_frame(t, st, a.wt, a.t0, a.Tg, a.halo);
  const long long f0q = bhd * a.Tv + a.halo + t;   // the query's frame
  const float* v0 = a.vid0 + f0q * frame;
  float* gv0 = a.g_vid0 + f0q * frame;
  const float* v1 = a.vid1 + (bhd * a.Tv + tj) * frame;
  float* gv1 = a.g_vid1 + (bhd * a.Tv + tj) * frame;
  // cotangent of cell (wi, wj) at g[(wi * ws + wj) * plane]
  const float* gd = a.g_d + (bhdt * a.W_t + st) * ws * ws * plane
                    + (long long)qh * a.nW + qw;
  const int ncell = ws * ws;

  // The active cells base .. base + 31 as a bitmask. The cotangent is the
  // largest array read, from device memory: the (query, slot)'s ng lanes
  // split its cells (lane g reads cells g, g + ng, ...), each reading 8 at
  // a time so that they are in flight together, and OR their masks.
  auto active_mask = [&](int base) {
    unsigned mask = 0u;
    const int nc = min(32, ncell - base);
    for (int j0 = g; j0 < nc; j0 += 8 * ng) {
      float gv[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int j = j0 + k * ng;
        gv[k] = j < nc ? __ldg(gd + (long long)(base + j) * plane) : 0.f;
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int j = j0 + k * ng, cell = base + j;
        const int wi = cell / ws, wj = cell - wi * ws;
        if (j < nc && gv[k] != 0.f && inb_f(lattice(ch, oh, s1, wi), H) &&
            inb_f(lattice(cw, ow, s1, wj), W))
          mask |= 1u << j;
      }
    }
    for (int off = 1; off < ng; off <<= 1) mask |= __shfl_xor_sync(seg, mask, off);
    return mask;
  };
  // their count, and the first 32
  const unsigned mask0 = active_mask(0);
  int nact = __popc(mask0);
  for (int base = 32; base < ncell; base += 32) nact += __popc(active_mask(base));

  // the box of E x E pixels at origin (bh0, bw0)
  const int E = a.box;
  const bool use_box = nact * ps * ps * (is_int ? 1 : 4) > E * E;
  // element e of this thread's box: vector e * blockDim.x + threadIdx.x
  // of the shared array, at byte address sbase + e * sstride
  const unsigned sstride = blockDim.x * VW * sizeof(float);
  const unsigned sbase = (unsigned)__cvta_generic_to_shared(smem) +
                         threadIdx.x * VW * sizeof(float);
  const int bh0 = (int)floorf(__fadd_rn(lattice(ch, oh, s1, 0), (float)(dil * po)));
  const int bw0 = (int)floorf(__fadd_rn(lattice(cw, ow, s1, 0), (float)(dil * po)));
  unsigned n_flush = 0, n_direct = 0, n_v0 = 0;
  int c0 = 0;   // this pass's first channel
  // add the VW channels x (when not all 0) to g_vid1 at pixel (ih, iw),
  // and y at (ih1, iw): both box elements are read before either is
  // written (ih1 != ih, or y is 0)
  auto put2 = [&](int ih, int ih1, int iw, const float* x, const float* y) {
    bool nx = false, ny = false;
#pragma unroll
    for (int k = 0; k < VW; ++k) {
      nx |= x[k] != 0.f;
      ny |= y[k] != 0.f;
    }
    const unsigned bx = (unsigned)(iw - bw0);
    const bool inx = use_box && nx && bx < (unsigned)E &&
                     (unsigned)(ih - bh0) < (unsigned)E;
    const bool iny = use_box && ny && bx < (unsigned)E &&
                     (unsigned)(ih1 - bh0) < (unsigned)E;
    const int ex = (ih - bh0) * E + (iw - bw0);
    const int ey = (ih1 - bh0) * E + (iw - bw0);
    float sx[VW], sy[VW];
    if (inx) sload<VW>(sx, sbase + ex * sstride);
    if (iny) sload<VW>(sy, sbase + ey * sstride);
    if (inx) {
#pragma unroll
      for (int k = 0; k < VW; ++k) sx[k] += x[k];
      sstore<VW>(sbase + ex * sstride, sx);
    } else if (nx) {
      n_direct += vatomic<VW>(gv1 + ((long long)ih * W + iw) * Fp + c0, x);
    }
    if (iny) {
#pragma unroll
      for (int k = 0; k < VW; ++k) sy[k] += y[k];
      sstore<VW>(sbase + ey * sstride, sy);
    } else if (ny) {
      n_direct += vatomic<VW>(gv1 + ((long long)ih1 * W + iw) * Fp + c0, y);
    }
  };

  float gch = 0.f, gcw = 0.f;
  for (int pass = 0; nact > 0 && pass < a.np; ++pass) {
    c0 = (pass * ng + g) * VW;
    if (use_box) {
      const float zero[VW] = {};
      for (int e = 0; e < E * E; ++e) sstore<VW>(sbase + e * sstride, zero);
    }
    for (int base = 0; base < ncell; base += 32) {
      const unsigned mask = base == 0 ? mask0 : active_mask(base);
      if (mask == 0u) continue;
      for (int pi = 0; pi < ps; ++pi) {
        const int dH = dil * (pi + po);
        const int rh = reflect_i(ref_h + dH, H);
        for (int pj = 0; pj < ps; ++pj) {
          const int dW = dil * (pj + po);
          const int rw = reflect_i(ref_w + dW, W);
          if (rh < 0 || rh >= H || rw < 0 || rw >= W) continue;
          const long long oq = ((long long)rh * W + rw) * Fp + c0;
          float p0[VW], acc[VW];
          vldg<VW>(p0, v0 + oq);
#pragma unroll
          for (int k = 0; k < VW; ++k) acc[k] = 0.f;
          float gsum = 0.f;
          bool active = false;
          // The g_vid1 terms of the last cells' two corner columns (cl,
          // cr) on corner rows (r0, r1), not yet added: consecutive cells
          // of a window row, stride1 apart, share corner columns, and
          // their terms are summed here first (float path).
          int r0 = INT_MIN, r1 = INT_MIN, cl = INT_MIN, cr = INT_MIN;
          float l0[VW], l1[VW], q0[VW], q1[VW];   // (r0|r1, cl|cr)
          // the tap row's geometry of the last window row wi seen (cells
          // come in row-major order)
          int wi_h = -1;
          float vh = 0.f, ph = 0.f;
          AxisCorner kh{};
          for (unsigned m = mask; m != 0u; m &= m - 1u) {
            const int cell = base + __ffs(m) - 1;
            const int wi = cell / ws, wj = cell - wi * ws;
            if (wi != wi_h) {
              wi_h = wi;
              vh = __fadd_rn(lattice(ch, oh, s1, wi), (float)dH);
              ph = reflect_f(vh, H);
              kh = axis_corner(ph, H);
            }
            if (!inb_f(ph, H)) continue;
            const float vw = __fadd_rn(lattice(cw, ow, s1, wj), (float)dW);
            const float pw = reflect_f(vw, W);
            if (!inb_f(pw, W)) continue;
            const float gc = __ldg(gd + (long long)cell * plane);
            gsum += gc;
            active = true;
            if (is_int) {
              const int ih = (int)ph, iw = (int)pw;
              float p1[VW], gp1[VW], none[VW];
              vldg<VW>(p1, v1 + ((long long)ih * W + iw) * Fp + c0);
#pragma unroll
              for (int k = 0; k < VW; ++k) {
                acc[k] += gc * p1[k];
                gp1[k] = l2 ? -2.f * gc * (p0[k] - p1[k]) : gc * p0[k];
                none[k] = 0.f;
              }
              put2(ih, ih, iw, gp1, none);
              continue;
            }
            const AxisCorner kw = axis_corner(pw, W);
            const float w00 = kh.w0 * kw.w0;
            const float w01 = kw.ok1 ? kh.w0 * kw.w1 : 0.f;
            const float w10 = kh.ok1 ? kh.w1 * kw.w0 : 0.f;
            const float w11 = (kh.ok1 && kw.ok1) ? kh.w1 * kw.w1 : 0.f;
            // d w / d ph and d w / d pw of each corner (0 beyond the frame)
            const float gh00 = -kw.w0, gh01 = kw.ok1 ? -kw.w1 : 0.f;
            const float gh10 = kh.ok1 ? kw.w0 : 0.f;
            const float gh11 = (kh.ok1 && kw.ok1) ? kw.w1 : 0.f;
            const float gw00 = -kh.w0, gw01 = kw.ok1 ? kh.w0 : 0.f;
            const float gw10 = kh.ok1 ? -kh.w1 : 0.f;
            const float gw11 = (kh.ok1 && kw.ok1) ? kh.w1 : 0.f;
            const float* row0 = v1 + (long long)kh.i0 * W * Fp + c0;
            const float* row1 = v1 + (long long)kh.i1 * W * Fp + c0;
            float c00[VW], c01[VW], c10[VW], c11[VW];
            vldg<VW>(c00, row0 + (long long)kw.i0 * Fp);
            vldg<VW>(c01, row0 + (long long)kw.i1 * Fp);
            vldg<VW>(c10, row1 + (long long)kw.i0 * Fp);
            vldg<VW>(c11, row1 + (long long)kw.i1 * Fp);
            float a00[VW], a01[VW], a10[VW], a11[VW];
            float dh = 0.f, dw = 0.f;
#pragma unroll
            for (int k = 0; k < VW; ++k) {
              const float pv = w00 * c00[k] + w01 * c01[k] + w10 * c10[k] + w11 * c11[k];
              acc[k] += gc * pv;
              const float gpv = l2 ? -2.f * gc * (p0[k] - pv) : gc * p0[k];
              a00[k] = gpv * w00;
              a01[k] = gpv * w01;
              a10[k] = gpv * w10;
              a11[k] = gpv * w11;
              dh += gpv * (gh00 * c00[k] + gh01 * c01[k] + gh10 * c10[k] + gh11 * c11[k]);
              dw += gpv * (gw00 * c00[k] + gw01 * c01[k] + gw10 * c10[k] + gw11 * c11[k]);
            }
            gch += reflect_sign(vh, H) * dh;
            gcw += reflect_sign(vw, W) * dw;
            // merge into the held columns where this cell's columns are
            // theirs, and add the columns it leaves behind
            if (kh.i0 == r0 && kh.i1 == r1 && kw.i0 == cl) {
#pragma unroll
              for (int k = 0; k < VW; ++k) {
                l0[k] += a00[k];
                l1[k] += a10[k];
              }
              if (kw.i1 == cr) {
#pragma unroll
                for (int k = 0; k < VW; ++k) {
                  q0[k] += a01[k];
                  q1[k] += a11[k];
                }
              } else {
                if (cr != cl) put2(r0, r1, cr, q0, q1);
                cr = kw.i1;
#pragma unroll
                for (int k = 0; k < VW; ++k) {
                  q0[k] = a01[k];
                  q1[k] = a11[k];
                }
              }
            } else if (kh.i0 == r0 && kh.i1 == r1 && kw.i0 == cr && cr != cl) {
              put2(r0, r1, cl, l0, l1);
#pragma unroll
              for (int k = 0; k < VW; ++k) {
                l0[k] = q0[k] + a00[k];
                l1[k] = q1[k] + a10[k];
                q0[k] = a01[k];
                q1[k] = a11[k];
              }
              cl = kw.i0;
              cr = kw.i1;
            } else {
              if (r0 != INT_MIN) {
                put2(r0, r1, cl, l0, l1);
                if (cr != cl) put2(r0, r1, cr, q0, q1);
              }
#pragma unroll
              for (int k = 0; k < VW; ++k) {
                l0[k] = a00[k];
                l1[k] = a10[k];
                q0[k] = a01[k];
                q1[k] = a11[k];
              }
              r0 = kh.i0;
              r1 = kh.i1;
              cl = kw.i0;
              cr = kw.i1;
            }
          }
          if (r0 != INT_MIN) {
            put2(r0, r1, cl, l0, l1);
            if (cr != cl) put2(r0, r1, cr, q0, q1);
          }
          if (!active) continue;
          // l2: sum_c 2 g_c (p0 - pv_c) = 2 (p0 sum_c g_c - sum_c g_c pv_c)
          float d0[VW];
#pragma unroll
          for (int k = 0; k < VW; ++k) d0[k] = l2 ? 2.f * (p0[k] * gsum - acc[k]) : acc[k];
          n_v0 += vatomic<VW>(gv0 + oq, d0);
        }
      }
    }
    if (use_box) {
      // the box's non-zero vectors, once each; only pixels of the frame
      // ever receive an add
      for (int by = 0; by < E; ++by) {
        for (int bx = 0; bx < E; ++bx) {
          float y[VW];
          sload<VW>(y, sbase + (by * E + bx) * sstride);
          bool any = false;
#pragma unroll
          for (int k = 0; k < VW; ++k) any |= y[k] != 0.f;
          if (any)
            n_flush += vatomic<VW>(
                gv1 + ((long long)(bh0 + by) * W + bw0 + bx) * Fp + c0, y);
        }
      }
    }
  }

  // the (query, slot)'s lanes hold its channel vectors: sum them
  for (int off = 1; off < ng; off <<= 1) {
    gch += __shfl_xor_sync(seg, gch, off);
    gcw += __shfl_xor_sync(seg, gcw, off);
  }
  if (g == 0) {
    a.g_ctr_h[c] = is_int ? 0.f : gch;
    a.g_ctr_w[c] = is_int ? 0.f : gcw;
  }

  if (a.stats) {
    const unsigned am = __activemask();
    const unsigned sf = __reduce_add_sync(am, n_flush);
    const unsigned sd = __reduce_add_sync(am, n_direct);
    const unsigned s0 = __reduce_add_sync(am, n_v0);
    const unsigned sc = __reduce_add_sync(am, g == 0 ? (unsigned)nact : 0u);
    if ((int)lane == __ffs(am) - 1) {
      atomicAdd(a.stats + 0, (unsigned long long)(sf + sd));
      atomicAdd(a.stats + 1, (unsigned long long)s0);
      atomicAdd(a.stats + 2, (unsigned long long)sf);
      atomicAdd(a.stats + 3, (unsigned long long)sc);
    }
  }
}

template <int VW>
int launch(const VolBwdArgs& a, long long n, cudaStream_t stream) {
  const int smem = a.box * a.box * kBoxThreads * VW * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      nls_vol_bwd_box_kernel<VW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  // all of the SM's unified memory that can be shared, so that two
  // blocks of boxes fit an SM
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(nls_vol_bwd_box_kernel<VW>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((n + kBoxThreads - 1) / kBoxThreads);
  nls_vol_bwd_box_kernel<VW><<<blocks, kBoxThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success). vw (1, 2 or
// 4), ng (a power of two up to 32) and np give Fp = vw * ng * np
// channels; box >= 1, the boxes' extent. The shipped entry's arguments
// with `box` before the stream. `stats`, when not null, gets added: [0]
// the global atomic instructions into g_vid1, [1] those into g_vid0, [2]
// the box flushes among [0], [3] the active (query, slot, cell) triples.
extern "C" int stnls_nls_vol_bwd(
    const float* vid0, const float* vid1, const float* ctr_h,
    const float* ctr_w, const float* g_d, float* g_vid0, float* g_vid1,
    float* g_ctr_h, float* g_ctr_w, unsigned long long* stats, int B, int HD,
    int T, int Fp, int H, int W, int nH, int nW, int W_t, int Tv, int t0,
    int Tg, int halo, int ws, int wt, int ps, int stride0, int dilation,
    float stride1, float s1_half, int l2, int full_ws, int use_adj,
    int is_int, int vw, int ng, int np, int box, void* stream_ptr) {
  VolBwdArgs a{vid0, vid1, ctr_h, ctr_w, g_d, g_vid0, g_vid1, g_ctr_h,
               g_ctr_w, stats, B, HD, T, Fp, H, W, nH, nW, W_t, Tv, t0, Tg,
               halo, ws, wt, ps, stride0, dilation, stride1, s1_half, l2,
               full_ws, use_adj, is_int, ng, np, box};
  if (Fp != vw * ng * np || ng < 1 || ng > 32 || (ng & (ng - 1)) ||
      (vw != 1 && vw != 2 && vw != 4) || box < 1)
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)B * HD * T * W_t * nH * nW * ng;
  if (n == 0) return 0;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  return vw == 4 ? launch<4>(a, n, stream)
                 : vw == 2 ? launch<2>(a, n, stream) : launch<1>(a, n, stream);
}
