// B5: the full non-local search volume, forward, for Hopper.
//
// Replaces the Pallas TPU kernel stnls_tpu/ops/nls_pallas.py:
// _make_fwd_kernel with emit="volume" (entry nls_pallas_volume, the
// forward of the custom_vjp _vol_op). Plain version:
// stnls_tpu_torch/ops/nls_vol_cuda.py::nls_volume_plain, which is
// ops/nls.lattice_search at the given centres.
//
// What it computes: for every query (b, hd, t, qh, qw), time slot st and
// window cell (wi, wj), the l2 or prod distance between the ps x ps x F
// query patch of vid0 and the key patch of vid1 in frame tj(t, st) at the
// lattice position ctr + stride1 * (cell - window offset), the reflected
// search centre ctr[b,hd,t,st,qh,qw] given (the flow walk stays in torch,
// so autograd chains the centres to the flows). Taps are reflected and
// read bilinearly (float) or at one pixel (int), with B1's geometry
// (nls_common.cuh); cells outside the frame hold the init value (+inf for
// l2, -inf for prod). Output dists [B,HD,T,W_t,ws,ws,nH,nW]: the volume
// that the self_action and top-K menu of
// search/non_local_search._self_action_topk then reduces. In a temporal
// chunk (time sharding, nls_pallas_volume's query_t0 / T_global mode) the
// T query frames are one chunk of the sequence and the videos hold Tv =
// T + 2*halo frames (nls_common.cuh, chunk_window_frame).
//
// What bounds it on the H100: loads. At the slice config a query reads
// 125 cells x 9 taps x 8 channels x 4 bilinear corners of vid1 from
// L1/L2, against 10 float operations a (tap, channel) (the bound: 0.220
// ms by operations; the 82 MB volume it writes, 0.025 ms by bytes). The
// first design issued every one of those corner reads as a scalar load
// from a planar video, the channels H*W apart, and recomputed the slot's
// window offsets (two divisions an axis) for each window row.
//
// What the design does about it:
// - Layout: the wrapper hands the kernel channels-last copies of both
//   videos, [B,HD,Tv,H,W,Fp] with Fp >= F zero-padded channels
//   (ops/nls_vol_cuda.py; B6 reads the same copies), so a pixel's
//   channels are Fp / VW vector loads of VW = 4 (2, 1 for F = 2, 1).
// - One thread per (query, slot) (a thread per (query, slot, window
//   row) measured slower, PERF.md), with
//   neighbouring threads on neighbouring qw, so each store of one cell
//   into [..,ws,ws,nH,nW] is coalesced. The slot's centre, window offsets
//   and frame are computed once.
// - Loop order: for each chunk of CELLS cells of a window row, window
//   row wi, tap row pi, tap column pj, and then the chunk's cells wj
//   (their sums in registers). A cell's corner column, and the column
//   weights, depend on (wj, pj) only: the thread computes them once per
//   chunk into a table of its own in shared memory (thread-minor) and
//   reads them for every window row and tap row. A tap row's corner rows
//   are the same for every cell and tap of the window row, so its row
//   geometry is computed once; the query tap's channels are loaded once
//   for the chunk's cells. At ps > 1 consecutive cells of one tap share
//   corner columns (stride1 <= 1): the thread keeps the last two corner
//   columns it read (both corner rows, all channels) in registers and
//   takes a corner from them when the corner's exactly computed integer
//   column is the one it holds; the values are the same floats, only
//   where they come from changes. At ps = 1 that reuse measured slower
//   (the register copies cost more than the loads) and is off.
// - Bitwise equal to the plain version: each cell's sum runs over taps in
//   (pi, pj) order, channels inside, corners in lattice_search's order,
//   one _rn operation at a time (no FMA): the order of the first design,
//   whose distances equal the plain volume's bitwise (softmax(-10 d)
//   amplifies one ulp of d into ~1e-3 of a weight's share).
// - Bodies: <PS, NV, VW, EXACT> with ps and F = NV * VW compiled in for
//   the pairs STNLS_VOL_COMPILED lists, and run-time bodies <0, NV, VW,
//   EXACT> for any (ps, F): NV = 1, 2 or 4 vectors of channels held in
//   registers, F compiled in where it fills them; above 16 channels a
//   tap's channels are summed in chunks read at each cell (no corner
//   reuse), in the same order. No atomics; deterministic.

#include <cuda_runtime.h>
#include <limits.h>
#include <math_constants.h>

#include "nls_common.cuh"
#include "vec_ops.cuh"

namespace {

struct VolArgs {
  const float* vid0;   // [B,HD,Tv,H,W,Fp] channels-last, channels >= F zero
  const float* vid1;   // [B,HD,Tv,H,W,Fp]
  const float* ctr_h;  // [B,HD,T,W_t,nH,nW] reflected centres (integers for int)
  const float* ctr_w;
  float* dists;        // [B,HD,T,W_t,ws,ws,nH,nW]
  int B, HD, T, F, Fp, H, W, nH, nW, W_t;
  int Tv, t0, Tg, halo;  // video frames and the chunk (nls_common.cuh)
  int ws, wt, ps, stride0, dilation;
  float stride1;       // float path; the int path passes max(1, int(stride1))
  float s1_half;       // stride1 * ((ws-1)/2), rounded once on the host
  int l2, full_ws, use_adj, is_int;
};

constexpr int CELLS = 8;     // cells of a window row summed in registers at a time
// take a corner column from the registers holding the last two read
constexpr bool kReuseColumns = true;

// The sum of one (tap, cell) over the channel vectors c0 .. c0 + NV - 1
// (those below nv, channels below F) added to s: corners in the plain
// version's order, one _rn operation at a time.
template <int NV, int VW>
__device__ __forceinline__ float tap_sum(float s, const float* q, const float* l0,
                                         const float* r0, const float* l1,
                                         const float* r1, float w00, float w01,
                                         float w10, float w11, int c0, int F,
                                         bool l2) {
#pragma unroll
  for (int v = 0; v < NV; ++v) {
#pragma unroll
    for (int c = 0; c < VW; ++c) {
      const int j = v * VW + c;
      if ((c0 + v) * VW + c < F) {
        float p1 = __fmul_rn(w00, l0[j]);
        p1 = __fadd_rn(p1, __fmul_rn(w01, r0[j]));
        p1 = __fadd_rn(p1, __fmul_rn(w10, l1[j]));
        p1 = __fadd_rn(p1, __fmul_rn(w11, r1[j]));
        const float df = q[j] - p1;
        s = __fadd_rn(s, l2 ? __fmul_rn(df, df) : __fmul_rn(q[j], p1));
      }
    }
  }
  return s;
}

// The int path's sum: one pixel p a tap, no weights.
template <int NV, int VW>
__device__ __forceinline__ float tap_sum_int(float s, const float* q,
                                             const float* p, int c0, int F,
                                             bool l2) {
#pragma unroll
  for (int v = 0; v < NV; ++v) {
#pragma unroll
    for (int c = 0; c < VW; ++c) {
      const int j = v * VW + c;
      if ((c0 + v) * VW + c < F) {
        const float df = q[j] - p[j];
        s = __fadd_rn(s, l2 ? __fmul_rn(df, df) : __fmul_rn(q[j], p[j]));
      }
    }
  }
  return s;
}

// the channel vectors c0 .. c0 + NV - 1 (those below nv) of one pixel
template <int NV, int VW>
__device__ __forceinline__ void load_px(float* x, const float* p, int c0, int nv) {
#pragma unroll
  for (int v = 0; v < NV; ++v)
    if (c0 + v < nv) vload<VW>(x + v * VW, p + (c0 + v) * VW);
}

// PS > 0: ps compiled in; PS = 0: taken from the arguments. EXACT: F =
// NV * VW compiled in (a tap's channels fill NV vectors); else F from the
// arguments, NV vectors of channels held at a time.
template <int PS, int NV, int VW, bool EXACT>
__global__ void __launch_bounds__(128) nls_vol_fwd_kernel(VolArgs a) {
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

  const int H = a.H, W = a.W, ws = a.ws, dil = a.dilation, Fp = a.Fp;
  const int ps = PS > 0 ? PS : a.ps;
  const int F = EXACT ? NV * VW : a.F;
  const int nv = (F + VW - 1) / VW;         // vectors holding channels < F
  const bool one = nv <= NV;                // a tap's channels in one chunk
  // corner columns from registers: at ps > 1 (measured slower at ps = 1,
  // where a cell is one tap and the copies cost more than the loads)
  const bool reuse = kReuseColumns && ps > 1;
  const bool l2 = a.l2;
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
  const float* v0 = a.vid0 + (bhd * a.Tv + a.halo + t) * frame;
  const float* v1 = a.vid1 + (bhd * a.Tv + tj) * frame;
  const float init = l2 ? CUDART_INF_F : -CUDART_INF_F;

  // The column geometry of a chunk of CELLS cells x ps tap columns, the
  // same for every window row and tap row: [3][CELLS * ps][blockDim.x],
  // the corner column (i0 * 2 + ok1, or -1 where the cell or the tap lies
  // outside the frame) and the two column weights (the second 0 where ok1
  // is not).
  extern __shared__ float tab[];
  const int bd = blockDim.x;
  int* t_col = reinterpret_cast<int*>(tab) + threadIdx.x;
  float* t_w0 = tab + CELLS * ps * bd + threadIdx.x;
  float* t_w1 = tab + 2 * CELLS * ps * bd + threadIdx.x;
  for (int wj0 = 0; wj0 < ws; wj0 += CELLS) {
    const int nc = min(CELLS, ws - wj0);
    for (int pj = 0; pj < ps; ++pj) {
      const float dW = (float)(dil * (pj + po));
      for (int u = 0; u < nc; ++u) {
        const float pw0 = lattice(cw, ow, s1, wj0 + u);
        const float pw = reflect_f(__fadd_rn(pw0, dW), W);
        int col = -1;
        float w0 = 0.f, w1 = 0.f;
        if (inb_f(pw0, W) && inb_f(pw, W)) {
          const AxisCorner kw = axis_corner(pw, W);
          col = kw.i0 * 2 + (kw.ok1 ? 1 : 0);
          w0 = kw.w0;
          w1 = kw.ok1 ? kw.w1 : 0.f;
        }
        const int e = (pj * CELLS + u) * bd;
        t_col[e] = col;
        t_w0[e] = w0;
        t_w1[e] = w1;
      }
    }
    for (int wi = 0; wi < ws; ++wi) {
      const float ph0 = lattice(ch, oh, s1, wi);
      const bool vh = inb_f(ph0, H);
      float acc[CELLS];
#pragma unroll
      for (int u = 0; u < CELLS; ++u) acc[u] = 0.f;
      for (int pi = 0; vh && pi < ps; ++pi) {
        const int dH = dil * (pi + po);
        const float ph = reflect_f(__fadd_rn(ph0, (float)dH), H);
        const int rh = reflect_i(ref_h + dH, H);
        if (!inb_f(ph, H) || rh < 0 || rh >= H) continue;
        const AxisCorner kh = axis_corner(ph, H);
        const float wh1 = kh.ok1 ? kh.w1 : 0.f;
        const float* row0 = v1 + (long long)kh.i0 * W * Fp;
        const float* row1 = v1 + (long long)kh.i1 * W * Fp;
        // the last two corner columns read (cl, cr), both corner rows
        float l0[NV * VW], l1[NV * VW], r0[NV * VW], r1[NV * VW];
        int cl = INT_MIN, cr = INT_MIN;
        for (int pj = 0; pj < ps; ++pj) {
          const int rw = reflect_i(ref_w + dil * (pj + po), W);
          if (rw < 0 || rw >= W) continue;
          const float* qp = v0 + ((long long)rh * W + rw) * Fp;
          float q[NV * VW];
          if (one) load_px<NV, VW>(q, qp, 0, nv);
#pragma unroll
          for (int u = 0; u < CELLS; ++u) {
            if (u >= nc) continue;
            const int e = (pj * CELLS + u) * bd;
            const int col = t_col[e];
            if (col < 0) continue;   // the cell or the tap outside the frame
            const int i0 = col >> 1, i1 = i0 + (col & 1);
            float s = 0.f;
            if (a.is_int) {
              const float* p = row0 + (long long)i0 * Fp;
              for (int c0 = 0; c0 < nv; c0 += NV) {
                if (!one) load_px<NV, VW>(q, qp, c0, nv);
                load_px<NV, VW>(l0, p, c0, nv);
                s = tap_sum_int<NV, VW>(s, q, l0, c0, F, l2);
              }
            } else {
              // lattice_search's weights: w01, w10, w11 are 0 where the
              // second column or row lies beyond the frame
              const float ww0 = t_w0[e], ww1 = t_w1[e];
              const float w00 = kh.w0 * ww0, w01 = kh.w0 * ww1;
              const float w10 = wh1 * ww0, w11 = wh1 * ww1;
              for (int c0 = 0; c0 < nv; c0 += NV) {
                if (!one) {
                  load_px<NV, VW>(q, qp, c0, nv);
                  cl = cr = INT_MIN;
                }
                // left column i0, then right column i1, each from the
                // registers where it is the column they hold
                if (i0 != cl) {
                  if (i0 == cr) {
#pragma unroll
                    for (int j = 0; j < NV * VW; ++j) {
                      l0[j] = r0[j];
                      l1[j] = r1[j];
                    }
                  } else {
                    load_px<NV, VW>(l0, row0 + (long long)i0 * Fp, c0, nv);
                    load_px<NV, VW>(l1, row1 + (long long)i0 * Fp, c0, nv);
                  }
                }
                if (i1 != cr) {
                  if (i1 == i0) {
#pragma unroll
                    for (int j = 0; j < NV * VW; ++j) {
                      r0[j] = l0[j];
                      r1[j] = l1[j];
                    }
                  } else {
                    load_px<NV, VW>(r0, row0 + (long long)i1 * Fp, c0, nv);
                    load_px<NV, VW>(r1, row1 + (long long)i1 * Fp, c0, nv);
                  }
                }
                if (reuse) {
                  cl = i0;
                  cr = i1;
                }
                s = tap_sum<NV, VW>(s, q, l0, r0, l1, r1, w00, w01, w10, w11,
                                    c0, F, l2);
              }
            }
            acc[u] = __fadd_rn(acc[u], s);
          }
        }
      }
      float* out = a.dists + ((bhdt * a.W_t + st) * ws + wi) * ws * plane
                   + (long long)qh * a.nW + qw;
#pragma unroll
      for (int u = 0; u < CELLS; ++u) {
        if (u >= nc) continue;
        const bool valid = vh && inb_f(lattice(cw, ow, s1, wj0 + u), W);
        out[(wj0 + u) * plane] = valid ? acc[u] : init;
      }
    }
  }
}

// the bytes of a block's column table
__host__ __device__ constexpr int table_bytes(int ps, int threads) {
  return 3 * CELLS * ps * threads * (int)sizeof(float);
}

template <int PS, int NV, int VW, bool EXACT>
cudaError_t launch(const VolArgs& a, cudaStream_t stream) {
  const long long n = (long long)a.B * a.HD * a.T * a.W_t * a.nH * a.nW;
  if (n == 0) return cudaSuccess;
  // 128 threads a block, or 32 where the column table of a large ps
  // would leave room for one block of 128 only
  const int threads = table_bytes(a.ps, 128) <= 96 * 1024 ? 128 : 32;
  const int smem = table_bytes(a.ps, threads);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      nls_vol_fwd_kernel<PS, NV, VW, EXACT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  nls_vol_fwd_kernel<PS, NV, VW, EXACT><<<blocks, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// The (ps, F a head) pairs with ps and F compiled in, the one list of
// them, as (ps, channel vectors, vector width). Every other pair, and
// every pair when `compiled` is 0, runs a run-time body.
#define STNLS_VOL_COMPILED(X) X(3, 2, 4) X(3, 4, 4) X(1, 1, 2)

// Returns cudaGetLastError() after the launch (0 on success); an invalid
// value when Fp is not a multiple of vw (1, 2 or 4) covering F.
extern "C" int stnls_nls_vol_fwd(
    const float* vid0, const float* vid1, const float* ctr_h,
    const float* ctr_w, float* dists, int B, int HD, int T, int F, int Fp,
    int H, int W, int nH, int nW, int W_t, int Tv, int t0, int Tg, int halo,
    int ws, int wt, int ps, int stride0, int dilation, float stride1,
    float s1_half, int l2, int full_ws, int use_adj, int is_int, int vw,
    int compiled, void* stream_ptr) {
  VolArgs a{vid0, vid1, ctr_h, ctr_w, dists, B, HD, T, F, Fp, H, W, nH, nW,
            W_t, Tv, t0, Tg, halo, ws, wt, ps, stride0, dilation, stride1,
            s1_half, l2, full_ws, use_adj, is_int};
  if ((vw != 1 && vw != 2 && vw != 4) || Fp % vw || Fp < F)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
#define STNLS_LAUNCH(P, NV, VW)                                        \
  if (compiled && ps == P && F == NV * VW && vw == VW)                 \
    return (int)launch<P, NV, VW, true>(a, stream);
  STNLS_VOL_COMPILED(STNLS_LAUNCH)
#undef STNLS_LAUNCH
  // the run-time bodies hold 1, 2 or 4 vectors, the fewest that take a
  // tap's channels in one chunk (4, in chunks, above 16 channels); F is
  // compiled in where it fills them (F = 1, 2, 4, 8, 16)
  const int nv = (F + vw - 1) / vw;
  if (vw == 1) return (int)launch<0, 1, 1, true>(a, stream);
  if (vw == 2) return (int)launch<0, 1, 2, true>(a, stream);
  if (nv <= 1)
    return (int)(F == 4 ? launch<0, 1, 4, true>(a, stream)
                        : launch<0, 1, 4, false>(a, stream));
  if (nv <= 2)
    return (int)(F == 8 ? launch<0, 2, 4, true>(a, stream)
                        : launch<0, 2, 4, false>(a, stream));
  return (int)(F == 16 ? launch<0, 4, 4, true>(a, stream)
                       : launch<0, 4, 4, false>(a, stream));
}

// 1 when (ps, F) has a body with ps and F compiled in, else 0.
extern "C" int stnls_nls_vol_compiled(int ps, int F) {
#define STNLS_HAS(P, NV, VW) if (ps == P && F == NV * VW) return 1;
  STNLS_VOL_COMPILED(STNLS_HAS)
#undef STNLS_HAS
  return 0;
}
