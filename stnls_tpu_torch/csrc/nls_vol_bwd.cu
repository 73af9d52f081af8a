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
// owners. Cells outside the frame (init-valued)
// and cells with a zero cotangent are skipped before anything is read or
// multiplied, so an inf never meets a zero.
//
// What bounds it on the H100: global atomic adds into the two videos. Per
// active (query, cell) pair it adds ps x ps taps x F channels x 4 corners into
// g_vid1; under topk_mode="each" with k=2 only 10 of the 125 cells of a
// query carry a cotangent, under topk_mode="none" all do.
//
// What the design does about it: one thread per (query, slot), with
// neighbouring threads on neighbouring qw (coalesced cotangent and centre
// accesses, neighbouring atomic addresses). Each thread first reads the
// slot's ws x ws cotangents once and keeps its active cells (non-zero
// cotangent, lattice position in the frame) as a bitmask of up to 32
// cells; it then loops tap-major over the set bits only. So the threads
// of a warp step through their own first, second, ... active cell
// together: a loop over all cells that skipped the inactive ones would
// run, for the whole warp, every cell that any of its 32 threads needs
// (nearly all 25 of them under per-frame top-2), with most threads idle.
// The query patch is the same for every cell, so the
// vid0 gradient of a tap is summed over the cells in registers,
// sum_c g_c * pv_c and sum_c g_c, and added with one atomic per (tap,
// channel) per (query, slot), not one per cell. ps and F are run-time
// arguments: the channels run in chunks of CH = 8 held in registers (the
// geometry of a cell is recomputed per chunk; a body with ps and F
// compiled in was no faster at (3, 8) or (3, 16), PERF.md). The centre
// gradients are summed over cells and taps in registers and written once,
// without atomics. The video gradients depend on the order of the
// atomics, so they are not bitwise deterministic (sums agree to float
// rounding). Shared-memory tiles of the video gradients are later work.

#include <cuda_runtime.h>

#include "nls_common.cuh"

namespace {

struct VolBwdArgs {
  const float* vid0;   // [B,HD,Tv,F,H,W]
  const float* vid1;   // [B,HD,Tv,F,H,W]
  const float* ctr_h;  // [B,HD,T,W_t,nH,nW] reflected centres (integers for int)
  const float* ctr_w;
  const float* g_d;    // [B,HD,T,W_t,ws,ws,nH,nW]
  float* g_vid0;       // [B,HD,Tv,F,H,W], zeroed by the caller
  float* g_vid1;       // [B,HD,Tv,F,H,W], zeroed by the caller
  float* g_ctr_h;      // [B,HD,T,W_t,nH,nW]
  float* g_ctr_w;
  int B, HD, T, F, H, W, nH, nW, W_t;
  int Tv, t0, Tg, halo;  // video frames and the chunk (nls_common.cuh)
  int ws, wt, ps, stride0, dilation;
  float stride1;       // float path; the int path passes max(1, int(stride1))
  float s1_half;       // stride1 * ((ws-1)/2), rounded once on the host
  int l2, full_ws, use_adj, is_int;
};

__global__ void __launch_bounds__(128) nls_vol_bwd_kernel(VolBwdArgs a) {
  constexpr int CH = 8;     // channels held in registers at a time
  const long long n = (long long)a.B * a.HD * a.T * a.W_t * a.nH * a.nW;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int qw = (int)(i % a.nW);
  long long r = i / a.nW;
  const int qh = (int)(r % a.nH);
  r /= a.nH;
  const int st = (int)(r % a.W_t);
  const long long bhdt = r / a.W_t;         // (b * HD + hd) * T + t
  const int t = (int)(bhdt % a.T);
  const long long bhd = bhdt / a.T;

  const int H = a.H, W = a.W, ws = a.ws, dil = a.dilation;
  const int ps = a.ps, F = a.F;
  const long long HW = (long long)H * W;
  const long long plane = (long long)a.nH * a.nW;
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
  const float* v0 = a.vid0 + f0q * F * HW;
  float* gv0 = a.g_vid0 + f0q * F * HW;
  const float* v1 = a.vid1 + (bhd * a.Tv + tj) * F * HW;
  float* gv1 = a.g_vid1 + (bhd * a.Tv + tj) * F * HW;
  // cotangent of cell (wi, wj) at g[(wi * ws + wj) * plane]
  const float* g = a.g_d + (bhdt * a.W_t + st) * ws * ws * plane
                   + (long long)qh * a.nW + qw;

  float gch = 0.f, gcw = 0.f;
  const int ncell = ws * ws;
  for (int base = 0; base < ncell; base += 32) {
    // the active cells base .. base+31 of this (query, slot), as a bitmask
    unsigned mask = 0u;
    const int nc = min(32, ncell - base);
    for (int j = 0; j < nc; ++j) {
      const int wi = (base + j) / ws, wj = (base + j) % ws;
      if (g[(long long)(base + j) * plane] != 0.f &&
          inb_f(lattice(ch, oh, s1, wi), H) && inb_f(lattice(cw, ow, s1, wj), W))
        mask |= 1u << j;
    }
    if (mask == 0u) continue;
    for (int pi = 0; pi < ps; ++pi) {
      const int dH = dil * (pi + po);
      const int rh = reflect_i(ref_h + dH, H);
      for (int pj = 0; pj < ps; ++pj) {
        const int dW = dil * (pj + po);
        const int rw = reflect_i(ref_w + dW, W);
        if (rh < 0 || rh >= H || rw < 0 || rw >= W) continue;
        const long long oq = (long long)rh * W + rw;
        for (int f0 = 0; f0 < F; f0 += CH) {
          // channels f0 .. f0 + CH - 1 of the tap (those below F)
          float p0[CH], acc[CH];
#pragma unroll
          for (int j = 0; j < CH; ++j) {
            p0[j] = f0 + j < F ? v0[(f0 + j) * HW + oq] : 0.f;
            acc[j] = 0.f;
          }
          float gsum = 0.f;
          bool active = false;
          for (unsigned m = mask; m != 0u; m &= m - 1u) {
            const int cell = base + __ffs(m) - 1;
            const int wi = cell / ws, wj = cell % ws;
            const float vh = __fadd_rn(lattice(ch, oh, s1, wi), (float)dH);
            const float ph = reflect_f(vh, H);
            if (!inb_f(ph, H)) continue;
            const float vw = __fadd_rn(lattice(cw, ow, s1, wj), (float)dW);
            const float pw = reflect_f(vw, W);
            if (!inb_f(pw, W)) continue;
            const float gc = g[(long long)cell * plane];
            gsum += gc;
            active = true;
            if (a.is_int) {
              const long long o = (long long)(int)ph * W + (int)pw;
#pragma unroll
              for (int j = 0; j < CH; ++j) {
                if (f0 + j < F) {
                  const long long fo = (f0 + j) * HW + o;
                  const float p1 = v1[fo];
                  acc[j] += gc * p1;
                  atomicAdd(gv1 + fo, a.l2 ? -2.f * gc * (p0[j] - p1) : gc * p0[j]);
                }
              }
              continue;
            }
            const Corners k = corners(ph, pw, H, W);
            const float w00 = k.wh0 * k.ww0;
            const float w01 = k.okw1 ? k.wh0 * k.ww1 : 0.f;
            const float w10 = k.okh1 ? k.wh1 * k.ww0 : 0.f;
            const float w11 = (k.okh1 && k.okw1) ? k.wh1 * k.ww1 : 0.f;
            // d w / d ph and d w / d pw of each corner (0 beyond the frame)
            const float gh00 = -k.ww0, gh01 = k.okw1 ? -k.ww1 : 0.f;
            const float gh10 = k.okh1 ? k.ww0 : 0.f;
            const float gh11 = (k.okh1 && k.okw1) ? k.ww1 : 0.f;
            const float gw00 = -k.wh0, gw01 = k.okw1 ? k.wh0 : 0.f;
            const float gw10 = k.okh1 ? -k.wh1 : 0.f;
            const float gw11 = (k.okh1 && k.okw1) ? k.wh1 : 0.f;
            float dh = 0.f, dw = 0.f;
#pragma unroll
            for (int j = 0; j < CH; ++j) {
              if (f0 + j >= F) continue;
              const float* p = v1 + (f0 + j) * HW;
              const float c00 = p[k.o00], c01 = p[k.o01];
              const float c10 = p[k.o10], c11 = p[k.o11];
              const float pv = w00 * c00 + w01 * c01 + w10 * c10 + w11 * c11;
              acc[j] += gc * pv;
              const float gpv = a.l2 ? -2.f * gc * (p0[j] - pv) : gc * p0[j];
              float* gp = gv1 + (f0 + j) * HW;
              if (w00 != 0.f) atomicAdd(gp + k.o00, gpv * w00);
              if (w01 != 0.f) atomicAdd(gp + k.o01, gpv * w01);
              if (w10 != 0.f) atomicAdd(gp + k.o10, gpv * w10);
              if (w11 != 0.f) atomicAdd(gp + k.o11, gpv * w11);
              dh += gpv * (gh00 * c00 + gh01 * c01 + gh10 * c10 + gh11 * c11);
              dw += gpv * (gw00 * c00 + gw01 * c01 + gw10 * c10 + gw11 * c11);
            }
            gch += reflect_sign(vh, H) * dh;
            gcw += reflect_sign(vw, W) * dw;
          }
          if (!active) break;     // no cell of this tap: none in any chunk
          // l2: sum_c 2 g_c (p0 - pv_c) = 2 (p0 sum_c g_c - sum_c g_c pv_c)
#pragma unroll
          for (int j = 0; j < CH; ++j) {
            if (f0 + j < F)
              atomicAdd(gv0 + (f0 + j) * HW + oq,
                        a.l2 ? 2.f * (p0[j] * gsum - acc[j]) : acc[j]);
          }
        }
      }
    }
  }
  a.g_ctr_h[c] = a.is_int ? 0.f : gch;
  a.g_ctr_w[c] = a.is_int ? 0.f : gcw;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int stnls_nls_vol_bwd(
    const float* vid0, const float* vid1, const float* ctr_h,
    const float* ctr_w, const float* g_d, float* g_vid0, float* g_vid1,
    float* g_ctr_h, float* g_ctr_w, int B, int HD, int T, int F, int H,
    int W, int nH, int nW, int W_t, int Tv, int t0, int Tg, int halo, int ws,
    int wt, int ps, int stride0, int dilation, float stride1, float s1_half,
    int l2, int full_ws, int use_adj, int is_int, void* stream_ptr) {
  VolBwdArgs a{vid0, vid1, ctr_h, ctr_w, g_d, g_vid0, g_vid1, g_ctr_h,
               g_ctr_w, B, HD, T, F, H, W, nH, nW, W_t, Tv, t0, Tg, halo, ws,
               wt, ps, stride0, dilation, stride1, s1_half, l2, full_ws,
               use_adj, is_int};
  const long long n = (long long)B * HD * T * W_t * nH * nW;
  if (n == 0) return 0;
  const int threads = 128;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  nls_vol_bwd_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream_ptr)>>>(a);
  return (int)cudaGetLastError();
}
