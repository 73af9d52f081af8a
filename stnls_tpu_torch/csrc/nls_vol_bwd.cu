// B6: backward of the full non-local search volume, for Hopper.
//
// Replaces the Pallas TPU kernel stnls_tpu/ops/nls_pallas_bwd.py:
// _make_bwd_kernel with emit="volume" (entry vol_bwd_pallas, the backward
// of the custom_vjp _vol_op). Plain version:
// stnls_tpu_torch/ops/nls_vol_cuda.py::nls_volume_bwd_plain, the VJP of
// ops/nls.lattice_search in the videos and the centres.
//
// What it computes: given the cotangent g[b,hd,t,st,wi,wj,qh,qw] of the
// volume B5 writes, the gradients of
//   d = sum over taps (pi, pj) and channels f of
//       l2: (p0 - pv)^2   or   prod: p0 * pv
// to vid0 (p0, the query tap), to vid1 (pv, bilinear over four corners for
// float, one pixel for int) and to the centres ctr_h, ctr_w of each
// (query, slot). The read rule differentiated is lattice_search's: the
// float tap position is reflected, then read at four corners, a corner
// beyond the frame weighted 0; so d pv / d ctr is the bilinear corner
// derivative times the reflection's sign (-1 for a tap reflected at a
// border). The window offsets are piecewise constant in the centre (floor,
// round): their derivative is 0, as in both packages. The centre
// gradients are 0 in the int path. A temporal chunk (time sharding) reads
// its videos as B5 does (nls_common.cuh, chunk_window_frame), and the
// gradients of the halo frames are the caller's to send back to their
// owners. Cells outside the frame (init-valued) and cells with a zero
// cotangent are skipped before anything is read or multiplied, so an inf
// never meets a zero.
//
// What bounds it on the H100: the adds into g_vid1. Per active (query,
// cell) pair the gradient of the key patch is ps x ps taps x F channels x
// 4 bilinear corners; under topk_mode="none" every cell of a slot is
// active. The first design issued each as a scalar global atomic: at the
// slice (163,840 queries x 5 slots x 25 cells, 9 taps, 8 channels) up to
// 5.9e9 on a dense cotangent, while a slot's cells, at stride1 = 0.5,
// touch only ~7 x 7 pixels: 18x fewer addresses than adds. Hopper's
// vector atomics retire at about the scalar rate (B2, PERF.md), so the
// count of atomic instructions matters, and with it the instructions
// around each add (geometry, the corner reads, the products).
//
// What the design does about it:
// - Layout (B2's): the wrapper hands the kernel channels-last copies of
//   the videos (B5's, [B,HD,Tv,H,W,Fp]) and channels-last accumulators of
//   the video gradients, zeroed before and transposed back after. One
//   thread per (query, slot, vector of VW = 1, 2 or 4 channels); the ng
//   lanes of a (query, slot) sit in one power-of-two segment of a warp and
//   sum its centre gradients with shuffles; np passes cover Fp = VW * ng *
//   np channels. A thread walks its slot's active cells (a bitmask of 32
//   at a time, its cotangents read 8 at a time) tap-major, so the vid0
//   gradient of a tap is summed over the cells in registers and added
//   once (one vector atomic a tap), and consecutive cells of one window
//   row share the tap row's geometry.
// - Merged columns: consecutive active cells of a window row are stride1
//   apart, so for one tap they share bilinear corner columns (at stride1
//   = 0.5 five cells touch four columns). The thread holds the last
//   cell's two corner columns (both corner rows, VW channels each) in
//   registers, adds the next cell's terms there while its columns are
//   theirs, and sends a column on only when the cells move past it: one
//   vector add a (column, corner row) in place of one a (cell, corner).
//   Each column goes to g_vid1 with one vector global atomic: 5.5e8 at
//   the slice on a dense cotangent, 10.9x fewer than the first design.
// - Not the design: a private box of the key region in shared memory per
//   thread, flushed once (PERF.md), cuts the global atomics to 6.9e7
//   at the slice but measured slower in every case timed: its shared
//   load/add/store per column costs about what a vector atomic does, and
//   its 100 KB of boxes a block leave 8 warps an SM (PERF.md).
// The centre gradients are summed in registers and written once per
// (query, slot) (deterministic, as the lanes' shuffle runs in a fixed
// order); the video gradients depend on the order of the atomics, so they
// are not bitwise deterministic (sums agree to float rounding).

#include <cuda_runtime.h>
#include <limits.h>

#include "nls_common.cuh"
#include "vec_ops.cuh"

namespace {

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
};

// Held to 128 registers at VW = 4 (2 blocks an SM) and to 85 at VW <= 2
// (3 blocks), the fastest of the bounds measured.
template <int VW>
__global__ void __launch_bounds__(256, VW == 4 ? 2 : 3)
    nls_vol_bwd_kernel(VolBwdArgs a) {
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

  unsigned n_v1 = 0, n_v0 = 0;
  int c0 = 0;   // this pass's first channel
  // add the VW channels x to g_vid1 at pixel (ih, iw) and y at (ih1, iw),
  // each with one vector atomic where it is not all 0
  auto put2 = [&](int ih, int ih1, int iw, const float* x, const float* y) {
    bool nx = false, ny = false;
#pragma unroll
    for (int k = 0; k < VW; ++k) {
      nx |= x[k] != 0.f;
      ny |= y[k] != 0.f;
    }
    if (nx) n_v1 += vatomic<VW>(gv1 + ((long long)ih * W + iw) * Fp + c0, x);
    if (ny) n_v1 += vatomic<VW>(gv1 + ((long long)ih1 * W + iw) * Fp + c0, y);
  };

  float gch = 0.f, gcw = 0.f;
  for (int pass = 0; nact > 0 && pass < a.np; ++pass) {
    c0 = (pass * ng + g) * VW;
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
    const unsigned s1 = __reduce_add_sync(am, n_v1);
    const unsigned s0 = __reduce_add_sync(am, n_v0);
    const unsigned sc = __reduce_add_sync(am, g == 0 ? (unsigned)nact : 0u);
    if ((int)lane == __ffs(am) - 1) {
      atomicAdd(a.stats + 0, (unsigned long long)s1);
      atomicAdd(a.stats + 1, (unsigned long long)s0);
      atomicAdd(a.stats + 3, (unsigned long long)sc);
    }
  }
}

template <int VW>
int launch(const VolBwdArgs& a, long long n, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((n + 255) / 256);
  nls_vol_bwd_kernel<VW><<<blocks, 256, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success). vw (1, 2 or
// 4), ng (a power of two up to 32) and np give Fp = vw * ng * np channels.
// `stats`, when not null, gets added (B2's layout): [0] the global atomic
// instructions into g_vid1, [1] those into g_vid0, [2] nothing (B6 makes
// no plain stores into a video gradient), [3] the active (query, slot,
// cell) triples.
extern "C" int stnls_nls_vol_bwd(
    const float* vid0, const float* vid1, const float* ctr_h,
    const float* ctr_w, const float* g_d, float* g_vid0, float* g_vid1,
    float* g_ctr_h, float* g_ctr_w, unsigned long long* stats, int B, int HD,
    int T, int Fp, int H, int W, int nH, int nW, int W_t, int Tv, int t0,
    int Tg, int halo, int ws, int wt, int ps, int stride0, int dilation,
    float stride1, float s1_half, int l2, int full_ws, int use_adj,
    int is_int, int vw, int ng, int np, void* stream_ptr) {
  VolBwdArgs a{vid0, vid1, ctr_h, ctr_w, g_d, g_vid0, g_vid1, g_ctr_h,
               g_ctr_w, stats, B, HD, T, Fp, H, W, nH, nW, W_t, Tv, t0, Tg,
               halo, ws, wt, ps, stride0, dilation, stride1, s1_half, l2,
               full_ws, use_adj, is_int, ng, np};
  if (Fp != vw * ng * np || ng < 1 || ng > 32 || (ng & (ng - 1)) ||
      (vw != 1 && vw != 2 && vw != 4))
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)B * HD * T * W_t * nH * nW * ng;
  if (n == 0) return 0;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  return vw == 4 ? launch<4>(a, n, stream)
                 : vw == 2 ? launch<2>(a, n, stream) : launch<1>(a, n, stream);
}
