// B1: fused non-local search forward with in-kernel top-K, for Hopper.
//
// Replaces the Pallas TPU kernel stnls_tpu/ops/nls_pallas.py:
// _make_fwd_kernel with emit="topk" (entry nls_pallas_topk). Plain version:
// stnls_tpu_torch/ops/nls_cuda.py::nls_topk_plain (exhaustive volume, then
// the _pallas_topk_aux selection rule).
//
// What it computes, per query (b, hd, t, qh, qw): l2 or prod distances
// between the ps x ps x F query patch of vid0 and the ws x ws key patches
// of vid1 on a stride1 lattice around the flow-shifted, reflected centre
// (shifted back inside the frame when full_ws), in each of the W_t frames
// of the boundary-shifted time window. Key reads are bilinear for float
// and integer for int. A sorted K-list is kept across all W_t*ws*ws cells,
// ranked by value, ties by lower position id; with `anchor` the self cell
// (lexicographically first argmin of |dt|+|dh|+|dw|) takes slot 0 and
// cell 0 competes under the self cell's position id, exactly as
// _pallas_topk_aux ranks them. In a temporal chunk (time sharding,
// nls_pallas_topk's query_t0 / T_global mode) the T query frames are one
// chunk of the sequence, the videos hold Tv = T + 2*halo frames
// (nls_common.cuh, chunk_window_frame), and the anchor's |dt| is the
// global frame difference.
//
// What bounds it on the H100: L1/L2 gather loads. At the slice config
// (F=8 a head, ps=3, ws=5, W_t=5) one query reads 125 cells x 9 taps x 8
// channels x 4 bilinear corners, about 36k floats, against ~72k flops:
// the kernel is load-issue bound, not flop bound; the video (2.6 MB a
// head at 128^2, T=5) stays resident in the 50 MB L2.
//
// What the design does about it: one thread per query with neighbouring
// threads on neighbouring qw, so a warp's corner reads of one tap fall on
// neighbouring addresses of the same rows (coalesced, L1-resident across
// the cells). ps and F (channels a head) are run-time arguments: the query
// patch is read from vid0 at each use through the read-only cache
// (GlobalQuery of nls_common.cuh). The pair listed at the dispatch below
// also has a body with ps and F compiled in, whose query patch lives in
// registers (RegQuery), faster there (PERF.md); the dispatch picks it
// unless the wrapper asks for the run-time body. Both sum in one order, so
// both give the plain volume's dists bitwise.
// The running list of KMAX ranked slots lives in thread-local memory (L1);
// the search sends more ranked slots to the volume route (B5).
// No shared memory, no atomics, no allocation; deterministic.
// Shared-memory query tiles and TMA staging of key rows are later work.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <limits.h>

#include "nls_common.cuh"

namespace {

constexpr int KMAX = 64;   // bound on the ranked slots (k, or k-1 anchored)

struct NlsArgs {
  const float* vid0;   // [B,HD,Tv,F,H,W]
  const float* vid1;   // [B,HD,Tv,F,H,W]
  const float* flows;  // [B,HDf,T,St,2,nH,nW], channel 0 = w, 1 = h
  float* dists;        // [B,HD,T,nH,nW,K]
  int* cells;          // [B,HD,T,nH,nW,K]
  int B, HD, T, F, H, W;
  int HDf, St, nH, nW;
  int Tv, t0, Tg, halo;  // video frames and the chunk (nls_common.cuh)
  int ws, wt, ps, stride0, dilation;
  float stride1;       // float path; the int path passes max(1, int(stride1))
  float s1_half;       // stride1 * ((ws-1)/2), rounded once on the host
  int K, anchor, l2, full_ws, use_adj, is_int;
};

// Centre and window offset of time slot st along both axes. Int-path
// values are integers held exactly in floats.
struct Slot {
  float ch, cw, oh, ow;
  int tj;
};

__device__ Slot slot_geometry(const NlsArgs& a, int b, int hd, int t, int qh,
                              int qw, int st, int ref_h, int ref_w) {
  const int T = a.T;
  const int W_t = min(2 * a.wt + 1, a.Tg);
  Slot s;
  s.tj = chunk_window_frame(t, st, a.wt, a.t0, a.Tg, a.halo);
  const int st_off = W_t - a.St;
  float fh = 0.f, fw = 0.f;
  if (st >= st_off) {
    const long long plane = (long long)a.nH * a.nW;
    const long long base =
        ((((long long)b * a.HDf + hd % a.HDf) * T + t) * a.St + (st - st_off)) * 2 * plane +
        (long long)qh * a.nW + qw;
    fw = a.flows[base];
    fh = a.flows[base + plane];
  }
  if (a.is_int) {
    s.ch = (float)reflect_i(ref_h + (int)rintf(fh), a.H);
    s.cw = (float)reflect_i(ref_w + (int)rintf(fw), a.W);
  } else {
    s.ch = reflect_f(__fadd_rn((float)ref_h, fh), a.H);
    s.cw = reflect_f(__fadd_rn((float)ref_w, fw), a.W);
  }
  window_offsets(a, s.ch, s.cw, &s.oh, &s.ow);
  return s;
}

__device__ __forceinline__ bool better(bool l2, float d, int p, float d2, int p2) {
  return l2 ? (d < d2 || (d == d2 && p < p2)) : (d > d2 || (d == d2 && p < p2));
}

// PS, FC > 0: ps and F compiled in; (0, 0): taken from the arguments.
template <int PS, int FC>
__global__ void __launch_bounds__(128) nls_topk_kernel(NlsArgs a) {
  const long long nq = (long long)a.B * a.HD * a.T * a.nH * a.nW;
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= nq) return;
  const int qw = (int)(q % a.nW);
  long long r = q / a.nW;
  const int qh = (int)(r % a.nH);
  r /= a.nH;
  const int t = (int)(r % a.T);
  r /= a.T;
  const int hd = (int)(r % a.HD);
  const int b = (int)(r / a.HD);

  const int H = a.H, W = a.W, ws = a.ws;
  const long long FHW = (long long)(FC > 0 ? FC : a.F) * H * W;
  const int ref_h = (qh * a.stride0) % H;
  const int ref_w = (qw * a.stride0) % W;
  const float s1 = a.stride1;
  const int W_t = min(2 * a.wt + 1, a.Tg);
  const long long bhd_v = ((long long)b * a.HD + hd) * a.Tv;  // first frame
  const int tq = t + a.halo;                                 // query frame

  typename QueryOf<PS, FC>::type qp;
  qp.load(a, a.vid0 + (bhd_v + tq) * FHW, ref_h, ref_w);

  // anchor: lexicographically first argmin of |dt| + |dh| + |dw|
  int self_idx = -1;
  if (a.anchor) {
    float best = CUDART_INF_F;
    for (int st = 0; st < W_t; ++st) {
      const Slot s = slot_geometry(a, b, hd, t, qh, qw, st, ref_h, ref_w);
      float mh = CUDART_INF_F, mw = CUDART_INF_F;
      int ah = 0, aw = 0;
      for (int i = 0; i < ws; ++i) {
        const float dh = fabsf(__fsub_rn(lattice(s.ch, s.oh, s1, i), (float)ref_h));
        if (dh < mh) { mh = dh; ah = i; }
        const float dw = fabsf(__fsub_rn(lattice(s.cw, s.ow, s1, i), (float)ref_w));
        if (dw < mw) { mw = dw; aw = i; }
      }
      const float tot = __fadd_rn(__fadd_rn(fabsf((float)(s.tj - tq)), mh), mw);
      if (tot < best) { best = tot; self_idx = (st * ws + ah) * ws + aw; }
    }
  }

  const int nslots = a.anchor ? a.K - 1 : a.K;
  const float init = a.l2 ? CUDART_INF_F : -CUDART_INF_F;
  float ld[KMAX];
  int lp[KMAX];
  for (int i = 0; i < nslots; ++i) { ld[i] = init; lp[i] = INT_MAX; }
  float self_d = init;

  for (int st = 0; st < W_t; ++st) {
    const Slot s = slot_geometry(a, b, hd, t, qh, qw, st, ref_h, ref_w);
    const float* v1 = a.vid1 + (bhd_v + s.tj) * FHW;
    for (int wi = 0; wi < ws; ++wi) {
      const float ph0 = lattice(s.ch, s.oh, s1, wi);
      const bool vh = inb_f(ph0, H);
      for (int wj = 0; wj < ws; ++wj) {
        const float pw0 = lattice(s.cw, s.ow, s1, wj);
        const int c = (st * ws + wi) * ws + wj;
        float d = init;
        if (vh && inb_f(pw0, W)) d = patch_dist(a, v1, qp, ph0, pw0);
        if (c == self_idx) { self_d = d; continue; }
        const int pos = (self_idx >= 0 && c == 0) ? self_idx : c;
        if (nslots > 0 && better(a.l2, d, pos, ld[nslots - 1], lp[nslots - 1])) {
          int i = nslots - 1;
          while (i > 0 && better(a.l2, d, pos, ld[i - 1], lp[i - 1])) {
            ld[i] = ld[i - 1];
            lp[i] = lp[i - 1];
            --i;
          }
          ld[i] = d;
          lp[i] = pos;
        }
      }
    }
  }

  float* od = a.dists + q * a.K;
  int* oc = a.cells + q * a.K;
  int o = 0;
  if (a.anchor) {
    od[0] = self_d;
    oc[0] = self_idx;
    o = 1;
  }
  for (int i = 0; i < nslots; ++i) {
    od[o + i] = ld[i];
    oc[o + i] = (lp[i] == self_idx) ? 0 : lp[i];
  }
}

template <int PS, int FC>
cudaError_t launch(const NlsArgs& a, cudaStream_t stream) {
  const long long nq = (long long)a.B * a.HD * a.T * a.nH * a.nW;
  if (nq == 0) return cudaSuccess;
  const int threads = 128;
  const unsigned blocks = (unsigned)((nq + threads - 1) / threads);
  nls_topk_kernel<PS, FC><<<blocks, threads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// The (ps, F a head) pairs with ps and F compiled in, the one list of
// them: ps=3 with 8 channels a head is what bench.py, __graft_entry__ and
// examples/attn_example.py run (at 16, the compiled body was no faster).
// Every other pair, and every pair when `compiled` is 0, runs the run-time
// body <0, 0>.
#define STNLS_NLS_COMPILED(X) X(3, 8)

// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for more than KMAX ranked slots.
extern "C" int stnls_nls_topk_fwd(
    const float* vid0, const float* vid1, const float* flows, float* dists,
    int* cells, int B, int HD, int T, int F, int H, int W, int HDf, int St,
    int nH, int nW, int Tv, int t0, int Tg, int halo, int ws, int wt, int ps,
    int stride0, int dilation, float stride1, float s1_half, int K,
    int anchor, int l2, int full_ws, int use_adj, int is_int, int compiled,
    void* stream_ptr) {
  NlsArgs a{vid0, vid1, flows, dists, cells, B, HD, T, F, H, W, HDf, St, nH, nW,
            Tv, t0, Tg, halo, ws, wt, ps, stride0, dilation, stride1, s1_half,
            K, anchor, l2, full_ws, use_adj, is_int};
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int nslots = anchor ? K - 1 : K;
  if (nslots < 0 || nslots > KMAX) return (int)cudaErrorInvalidValue;
#define STNLS_LAUNCH(P, FC) \
  if (compiled && ps == P && F == FC) return (int)launch<P, FC>(a, stream);
  STNLS_NLS_COMPILED(STNLS_LAUNCH)
#undef STNLS_LAUNCH
  return (int)launch<0, 0>(a, stream);
}

// 1 when (ps, F) has a body with ps and F compiled in, else 0.
extern "C" int stnls_nls_topk_compiled(int ps, int F) {
#define STNLS_HAS(P, FC) if (ps == P && F == FC) return 1;
  STNLS_NLS_COMPILED(STNLS_HAS)
#undef STNLS_HAS
  return 0;
}
