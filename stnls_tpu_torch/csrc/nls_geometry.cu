// G1 and G2: the lazy top-K route's cell geometry and its flow backward,
// for Hopper.
//
// Replaces, on CUDA tensors, the torch composition of the lazy route
// (search/non_local_search._sparse_assemble): ops/nls_k.cells_geometry,
// the stack of its offsets and the anchored slot 0. Plain version:
// stnls_tpu_torch/ops/nls_geometry_cuda.py::nls_geometry_plain. It has no
// Pallas counterpart: the JAX package builds this geometry in XLA.
//
// What G1 computes, per selected cell (b, hd, t, qh, qw, k) of the cells
// B1 wrote (flat ids (st*ws + wi)*ws + wj): the flow-shifted, reflected
// centre of time slot st (flows read at head hd % HDf; the reference
// frame's slot has no flow where the flows hold W_t - 1 slots), the window
// offsets, the sampled key position (prop_h, prop_w), whether it lies in
// the frame (valid), the target frame tj (an index into the videos, which
// in a temporal chunk start `halo` frames before the chunk's first query
// frame) and the offsets (dt, dh, dw), dt the global frame difference; all
// of them in the int path from rounded flows, the offsets int32. Under an
// anchored self_action slot 0's offsets are exact zeros. The geometry is
// nls_common.cuh's, which B1 ranks the cells by, so the positions are B1's
// lattice and cells_geometry's bitwise.
//
// What bounds it on the H100: memory, then the arithmetic of each cell.
// Nothing is read from the videos; at 1080p (K 10, two heads, T 10: 415 M
// cells) it reads 1.7 GB of cells and 1 GB of flows and writes 10.4 GB
// (positions 3.3, frames 1.7, validity 0.4, offsets 5.0): 3.9 ms at 3.35
// TB/s; a variant that writes the same bytes without the geometry took
// 4.2 ms on the card. Each cell's geometry (two gathered flows, the
// reflection, the window offsets' divisions) is ~100 instructions.
//
// What the design does about it (variants timed on the card, PERF.md):
//   - Every output is written once, in its final layout, by stores a warp
//     coalesces: one thread per two neighbouring cells, so the cells read
//     and the positions, frames and validity written are contiguous across
//     a warp, two cells a vector store. A thread per query looping over its
//     K cells would store K apart (40 bytes at K 10), 32 sectors a warp
//     instruction. The offsets, three words a cell, pass through a warp's
//     192 words of shared memory and leave as six contiguous rows.
//   - Few registers (40: six blocks, 1,536 threads an SM): the stores and
//     the two dependent loads of a cell (its id, then its slot's flows)
//     are hidden by the warps an SM holds; at 48 and 58 registers it ran
//     6% and 14% slower at 1080p.
//   - The divisions by K, nW, ws*ws and ws take a multiplier made on the
//     host, and where stride1 is a power of two the window offsets divide
//     by it as a multiplication by 1 / stride1, the same float (x * 2^-k
//     rounded once either way): ~9% of the time at 1080p.
//   - Neighbouring blocks take the same queries of every head, so the flows
//     that the heads share (HDf = 1) come from L2 for all but the first.
//   - The flows are gathered by slot: a warp's ~6 queries read neighbouring
//     words of each slot plane, through L1. The grid's y walks the (b, t)
//     planes, so the index math inside a plane stays 32-bit.
//
// G2, the flows' gradient (float path): d prop / d flow is the reflection's
// sign at the slot's centre, and dh, dw follow the positions (the window
// offsets are detached, dt carries none), so each slot flow gets
// sign * (sum of g_prop + g_offset over the cells of that slot), summed
// over the heads hd = hf, hf + HDf, ... that read it. One thread per (b,
// hf, t, query) reads each of its cells once, adds its cotangents to the
// accumulators of its slot, held in registers for up to SLOTS slots a pass
// (one pass for wt <= 3), and writes its slots once: no atomics,
// deterministic.

#include <cuda_runtime.h>

#include <cmath>

#include "nls_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MIN_BLOCKS = 6;        // an SM's blocks: at most 40 registers
constexpr int WARPS = THREADS / 32;
constexpr int CPT = 2;               // G1's cells a thread
constexpr int MAX_PLANES = 65535;    // gridDim.y
constexpr int SLOTS = 8;             // G2's slots a pass over the cells

// n / d for 0 <= n < 2^31 by a multiply and a shift (Granlund and
// Montgomery, as CUTLASS's FastDivmod), the multiplier made on the host.
struct FastDiv {
  int d;
  unsigned mul, shr;

  void init(int div) {
    d = div;
    mul = shr = 0;
    if (div == 1) return;
    unsigned l = 0;
    while ((1u << l) < (unsigned)div) ++l;
    mul = (unsigned)(((1ull << (31 + l)) + div - 1) / div);
    shr = l - 1;
  }
  __device__ __forceinline__ int operator()(int n) const {
    return d == 1 ? n : (int)(__umulhi((unsigned)n, mul) >> shr);
  }
};

struct GeoArgs {
  const int* cells;      // [B,HD,T,nH,nW,K]
  const float* flows;    // [B,HDf,T,St,2,nH,nW], channel 0 = w, 1 = h
  float* prop_h;         // [B,HD,T,nH,nW,K]
  float* prop_w;
  int* tj;
  unsigned char* valid;
  unsigned* inds;        // [B,HD,T,nH,nW,K,3]: float, or int32 (is_int)
  int B, HD, T, H, W, HDf, St, nH, nW, K;
  int t0, Tg, halo;      // the chunk (nls_common.cuh)
  int ws, wt, stride0;
  float stride1;         // float path; the int path passes max(1, int(stride1))
  float s1_half;         // stride1 * ((ws-1)/2), rounded once on the host
  int full_ws, is_int, anchor;
  int s1_pow2;           // stride1 is a power of two
  float inv_s1;          // 1 / stride1, exact where s1_pow2
  FastDiv div_K, div_nW, div_wsq, div_ws;
};

// The flows (fh, fw) of slot st at query q of plane (b, head, t): zero for
// the reference frame's missing slot.
template <class A>
__device__ __forceinline__ void slot_flow(const A& a, int b, int hf, int t,
                                          int st, int q, float* fh, float* fw) {
  const int st_off = min(2 * a.wt + 1, a.Tg) - a.St;
  *fh = 0.f;
  *fw = 0.f;
  if (st < st_off) return;
  const long long plane = (long long)a.nH * a.nW;
  const long long at =
      ((((long long)b * a.HDf + hf) * a.T + t) * a.St + (st - st_off)) * 2 * plane + q;
  *fw = __ldg(a.flows + at);
  *fh = __ldg(a.flows + at + plane);
}

// nls_common.cuh's ws_offset_f for a stride1 that is a power of two, its
// divisions by stride1 taken as multiplications by 1 / stride1: the same
// float.
__device__ float ws_offset_pow2(float xi, const GeoArgs& a, int L) {
  float off = (float)((a.ws - 1) / 2);
  if (!a.full_ws) return off;
  float off_min = floorf(__fmul_rn(xi, a.inv_s1));
  if (__fsub_rn(xi, a.s1_half) < 0.f) off = off_min;
  float x_max = __fadd_rn(xi, __fmul_rn(a.stride1, __fsub_rn((float)(a.ws - 1), off)));
  float off_max = ceilf(__fadd_rn(__fmul_rn(__fsub_rn(xi, (float)(L - 1)), a.inv_s1),
                                  (float)(a.ws - 1)));
  if (x_max > (float)(L - 1)) off = off_max;
  return rintf(off);
}

// One cell's outputs; o0-o2 the bits of its offsets (dt, dh, dw).
struct Cell {
  float ph, pw;
  int tj;
  unsigned char ok;
  unsigned o0, o1, o2;
};

// Cell i of plane (b, hd, t), whose cells start at e0.
__device__ __forceinline__ Cell cell_geometry(const GeoArgs& a, int b, int hd, int t,
                                              long long e0, int i) {
  const int q = a.div_K(i), k = i - q * a.K;
  const int qh = a.div_nW(q), qw = q - qh * a.nW;
  const int c = __ldg(a.cells + e0 + i);
  const int st = a.div_wsq(c), rem = c - st * a.ws * a.ws;
  const int wi = a.div_ws(rem), wj = rem - wi * a.ws;
  const int ref_h = (qh * a.stride0) % a.H;
  const int ref_w = (qw * a.stride0) % a.W;
  float fh, fw;
  slot_flow(a, b, hd % a.HDf, t, st, q, &fh, &fw);
  float ch, cw, oh, ow;
  if (a.is_int) {
    ch = (float)reflect_i(ref_h + (int)rintf(fh), a.H);
    cw = (float)reflect_i(ref_w + (int)rintf(fw), a.W);
  } else {
    ch = reflect_f(__fadd_rn((float)ref_h, fh), a.H);
    cw = reflect_f(__fadd_rn((float)ref_w, fw), a.W);
  }
  if (!a.is_int && a.s1_pow2) {
    oh = ws_offset_pow2(ch, a, a.H);
    ow = ws_offset_pow2(cw, a, a.W);
  } else {
    window_offsets(a, ch, cw, &oh, &ow);
  }
  Cell r;
  r.ph = lattice(ch, oh, a.stride1, wi);
  r.pw = lattice(cw, ow, a.stride1, wj);
  const int tg = a.t0 + t;                 // the query's global frame
  const int tjg = window_frame(tg, st, a.wt, a.Tg);
  r.tj = tjg - a.t0 + a.halo;
  r.ok = (unsigned char)(inb_f(r.ph, a.H) && inb_f(r.pw, a.W));
  r.o0 = r.o1 = r.o2 = 0u;
  if (!(a.anchor && k == 0)) {
    if (a.is_int) {
      r.o0 = (unsigned)(tjg - tg);
      r.o1 = (unsigned)((int)r.ph - ref_h);
      r.o2 = (unsigned)((int)r.pw - ref_w);
    } else {
      r.o0 = __float_as_uint((float)(tjg - tg));
      r.o1 = __float_as_uint(__fsub_rn(r.ph, (float)ref_h));
      r.o2 = __float_as_uint(__fsub_rn(r.pw, (float)ref_w));
    }
  }
  return r;
}

// grid: x = (chunk of THREADS * CPT cells) * HD + head, y = (b, t) planes
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) nls_geometry_fwd_kernel(GeoArgs a) {
  __shared__ unsigned stage[WARPS][3 * 32 * CPT];
  const int n = a.nH * a.nW * a.K;         // cells of a (b, hd, t) plane
  const int hd = blockIdx.x % a.HD;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i0 = ((blockIdx.x / a.HD) * THREADS + threadIdx.x) * CPT;
  const int first = i0 - lane * CPT;       // the warp's first cell
  for (int p = blockIdx.y; p < a.B * a.T; p += gridDim.y) {
    const int t = p % a.T, b = p / a.T;
    const long long e0 = (((long long)b * a.HD + hd) * a.T + t) * n;
    Cell c[CPT];
#pragma unroll
    for (int u = 0; u < CPT; ++u) {
      if (i0 + u < n) {
        c[u] = cell_geometry(a, b, hd, t, e0, i0 + u);
      } else {
        c[u].o0 = c[u].o1 = c[u].o2 = 0u;
      }
    }
    const long long e = e0 + i0;
    if ((e & 1) == 0 && i0 + 1 < n) {
      *reinterpret_cast<float2*>(a.prop_h + e) = make_float2(c[0].ph, c[1].ph);
      *reinterpret_cast<float2*>(a.prop_w + e) = make_float2(c[0].pw, c[1].pw);
      *reinterpret_cast<int2*>(a.tj + e) = make_int2(c[0].tj, c[1].tj);
      *reinterpret_cast<unsigned short*>(a.valid + e) =
          (unsigned short)(c[0].ok | (c[1].ok << 8));
    } else {
#pragma unroll
      for (int u = 0; u < CPT; ++u) {
        if (i0 + u < n) {
          a.prop_h[e + u] = c[u].ph;
          a.prop_w[e + u] = c[u].pw;
          a.tj[e + u] = c[u].tj;
          a.valid[e + u] = c[u].ok;
        }
      }
    }
    // the warp's cells' offsets leave as contiguous rows of 32 words
#pragma unroll
    for (int u = 0; u < CPT; ++u) {
      unsigned* s = stage[warp] + 3 * (lane * CPT + u);
      s[0] = c[u].o0;
      s[1] = c[u].o1;
      s[2] = c[u].o2;
    }
    __syncwarp();
    unsigned* out = a.inds + (e0 + first) * 3;
#pragma unroll
    for (int r = 0; r < 3 * CPT; ++r) {
      const int j = lane + 32 * r;
      if (first + j / 3 < n) out[j] = stage[warp][j];
    }
    __syncwarp();
  }
}

struct GeoBwdArgs {
  const int* cells;      // [B,HD,T,nH,nW,K]
  const float* flows;    // [B,HDf,T,St,2,nH,nW]
  const float* g_ph;     // [B,HD,T,nH,nW,K] or null (no cotangent)
  const float* g_pw;
  const float* g_inds;   // [B,HD,T,nH,nW,K,3] or null
  float* g_flows;        // [B,HDf,T,St,2,nH,nW], every slot written
  int B, HD, T, H, W, HDf, St, nH, nW, K;
  int Tg, ws, wt, stride0, anchor;
};

__global__ void __launch_bounds__(THREADS) nls_geometry_bwd_kernel(GeoBwdArgs a) {
  const long long nq = (long long)a.B * a.HDf * a.T * a.nH * a.nW;
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= nq) return;
  const int nHW = a.nH * a.nW;
  const int q = (int)(idx % nHW);
  long long r = idx / nHW;
  const int t = (int)(r % a.T);
  r /= a.T;
  const int hf = (int)(r % a.HDf);
  const int b = (int)(r / a.HDf);
  const int qh = q / a.nW, qw = q - qh * a.nW;
  const int ref_h = (qh * a.stride0) % a.H;
  const int ref_w = (qw * a.stride0) % a.W;
  const int wsq = a.ws * a.ws;
  const int W_t = min(2 * a.wt + 1, a.Tg);
  const int st_off = W_t - a.St;
  const long long plane = nHW;
  // one pass over the cells for up to SLOTS slots, each cell's cotangents
  // added to its slot's accumulators (registers: the slot is matched
  // against an unrolled index)
  for (int s0 = st_off; s0 < W_t; s0 += SLOTS) {
    float gh[SLOTS], gw[SLOTS];
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) gh[s] = gw[s] = 0.f;
    for (int hd = hf; hd < a.HD; hd += a.HDf) {
      const long long e = ((((long long)b * a.HD + hd) * a.T + t) * nHW + q) * a.K;
      for (int k = 0; k < a.K; ++k) {
        const int st = __ldg(a.cells + e + k) / wsq - s0;
        if (st < 0 || st >= SLOTS) continue;
        float vh = 0.f, vw = 0.f;
        if (a.g_ph) vh = __ldg(a.g_ph + e + k);
        if (a.g_pw) vw = __ldg(a.g_pw + e + k);
        if (a.g_inds && !(a.anchor && k == 0)) {
          vh += __ldg(a.g_inds + (e + k) * 3 + 1);
          vw += __ldg(a.g_inds + (e + k) * 3 + 2);
        }
#pragma unroll
        for (int s = 0; s < SLOTS; ++s) {
          if (s == st) {
            gh[s] += vh;
            gw[s] += vw;
          }
        }
      }
    }
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      const int st = s0 + s;
      if (st < W_t) {
        float fh, fw;
        slot_flow(a, b, hf, t, st, q, &fh, &fw);
        const long long at =
            ((((long long)b * a.HDf + hf) * a.T + t) * a.St + (st - st_off)) * 2 * plane + q;
        a.g_flows[at] = reflect_sign(__fadd_rn((float)ref_w, fw), a.W) * gw[s];
        a.g_flows[at + plane] = reflect_sign(__fadd_rn((float)ref_h, fh), a.H) * gh[s];
      }
    }
  }
}

}  // namespace

// G1. Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue where a plane's offsets (3 * nH * nW * K words)
// overflow 32 bits.
extern "C" int stnls_nls_geometry_fwd(
    const int* cells, const float* flows, float* prop_h, float* prop_w,
    int* tj, unsigned char* valid, void* inds, int B, int HD, int T, int H,
    int W, int HDf, int St, int nH, int nW, int K, int t0, int Tg, int halo,
    int ws, int wt, int stride0, float stride1, float s1_half, int full_ws,
    int is_int, int anchor, void* stream_ptr) {
  GeoArgs a{cells, flows, prop_h, prop_w, tj, valid, static_cast<unsigned*>(inds),
            B, HD, T, H, W, HDf, St, nH, nW, K, t0, Tg, halo, ws, wt, stride0,
            stride1, s1_half, full_ws, is_int, anchor};
  int exp2;
  a.s1_pow2 = std::frexp(stride1, &exp2) == 0.5f;
  a.inv_s1 = 1.f / stride1;
  a.div_K.init(K);
  a.div_nW.init(nW);
  a.div_wsq.init(ws * ws);
  a.div_ws.init(ws);
  const long long n = (long long)nH * nW * K;
  const long long chunks = (n + THREADS * CPT - 1) / (THREADS * CPT);
  const long long planes = (long long)B * T;
  if (3 * n + 3 * THREADS * CPT > 0x7fffffffLL || chunks * HD > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (n == 0 || planes == 0 || HD == 0) return 0;
  const dim3 grid((unsigned)(chunks * HD),
                  (unsigned)(planes < MAX_PLANES ? planes : MAX_PLANES));
  nls_geometry_fwd_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream_ptr)>>>(a);
  return (int)cudaGetLastError();
}

// G2. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int stnls_nls_geometry_bwd(
    const int* cells, const float* flows, const float* g_ph, const float* g_pw,
    const float* g_inds, float* g_flows, int B, int HD, int T, int H, int W,
    int HDf, int St, int nH, int nW, int K, int Tg, int ws, int wt,
    int stride0, int anchor, void* stream_ptr) {
  GeoBwdArgs a{cells, flows, g_ph, g_pw, g_inds, g_flows, B, HD, T, H, W, HDf,
               St, nH, nW, K, Tg, ws, wt, stride0, anchor};
  const long long nq = (long long)B * HDf * T * nH * nW;
  if (nq == 0) return 0;
  nls_geometry_bwd_kernel<<<(unsigned)((nq + THREADS - 1) / THREADS), THREADS, 0,
                            static_cast<cudaStream_t>(stream_ptr)>>>(a);
  return (int)cudaGetLastError();
}
