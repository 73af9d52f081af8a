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
// What bounds it on the H100: the dependent chain of each cell (geometry,
// gather loads through L1/L2, a sum rounded one add at a time, the rank
// test), hidden only by the warps an SM holds. At the slice config (F=8 a
// head, ps=3, ws=5, W_t=5) one query reads 125 cells x 9 taps x 8 channels
// x 4 bilinear corners, about 36k floats; at 1080p ((ps, F) = (1, 2),
// W_t=7) a cell is 8 reads and ~90 instructions, 7.3e9 cells a step.
//
// What the design does about it: one thread per query, neighbouring
// threads on neighbouring qw, so a warp's corner reads of one tap fall on
// neighbouring addresses of the same rows (coalesced, L1-resident across
// the cells), and few registers, so that many warps hide the chain.
//   - Each slot's geometry (centre, window offsets, its anchor candidate)
//     is computed once: the anchor and the cells run in one pass. The
//     list keeps one entry more than it returns; at the end the self cell
//     leaves it and cell 0 enters under the self cell's id, which ranks
//     exactly as skipping the self cell during the scan.
//   - The ranked list lives in shared memory, one column a thread (no
//     bank conflicts), not in local memory, and not in registers: a list
//     of NS registers (buckets of 4, 8, 16, insertion unrolled with
//     `i < n` as a predicate) took registers from the warps that hide the
//     chain and ran slower at every case measured (PERF.md).
//   - The bodies with ps and F compiled in (STNLS_NLS_COMPILED) hold the
//     query patch in registers (RegQuery); (1, 2) is the 1080p search's.
//   - Key regions are read through L1/L2, not staged in shared memory: a
//     block-tiled version that staged each slot's region with cp.async
//     measured no faster on the card (PERF.md).
// Sums run in the plain version's order without FMAs (nls_common.cuh), so
// the dists are the plain volume's bitwise; no tensor cores, since wgmma
// would reassociate the sums. No atomics, no allocation; deterministic.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <limits.h>

#include "nls_common.cuh"

namespace {

extern __shared__ float smem_dyn[];   // the ranked lists

constexpr int KMAX = 64;   // bound on the ranked slots (k, or k-1 anchored)
constexpr int THREADS = 128;

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
  int nkeep;           // list entries: the ranked slots, +1 anchored
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

// The ranked list of one query in shared memory: entry i of thread tid at
// i * stride + tid, sorted by value, ties by lower position id; the last
// entry is the reject threshold.
struct RankList {
  float* ld;
  int* lp;
  int stride, n;
  float init;

  __device__ __forceinline__ void bind(float* d, int* p, int s) {
    ld = d;
    lp = p;
    stride = s;
  }
  __device__ __forceinline__ void start(int nkeep, float init_d) {
    n = nkeep;
    init = init_d;
    for (int i = 0; i < n; ++i) { ld[i * stride] = init_d; lp[i * stride] = INT_MAX; }
  }
  __device__ __forceinline__ void insert(bool l2, float d, int pos) {
    if (n == 0 || !better(l2, d, pos, ld[(n - 1) * stride], lp[(n - 1) * stride])) return;
    int i = n - 1;
    while (i > 0 && better(l2, d, pos, ld[(i - 1) * stride], lp[(i - 1) * stride])) {
      ld[i * stride] = ld[(i - 1) * stride];
      lp[i * stride] = lp[(i - 1) * stride];
      --i;
    }
    ld[i * stride] = d;
    lp[i * stride] = pos;
  }
  __device__ __forceinline__ void remove(int pos) {
    int i = 0;
    while (i < n && lp[i * stride] != pos) ++i;
    if (i == n) return;
    for (; i + 1 < n; ++i) {
      ld[i * stride] = ld[(i + 1) * stride];
      lp[i * stride] = lp[(i + 1) * stride];
    }
    ld[(n - 1) * stride] = init;
    lp[(n - 1) * stride] = INT_MAX;
  }
  __device__ __forceinline__ void write(float* od, int* oc, int count, int self_idx) const {
    for (int i = 0; i < count; ++i) {
      od[i] = ld[i * stride];
      oc[i] = (lp[i * stride] == self_idx) ? 0 : lp[i * stride];
    }
  }
};

// PS, FC > 0: ps and F compiled in; (0, 0): taken from the arguments.
template <int PS, int FC>
__global__ void __launch_bounds__(THREADS) nls_topk_kernel(NlsArgs a) {
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

  const int nslots = a.anchor ? a.K - 1 : a.K;
  const float init = a.l2 ? CUDART_INF_F : -CUDART_INF_F;
  RankList list;
  list.bind(smem_dyn + threadIdx.x,
            reinterpret_cast<int*>(smem_dyn + a.nkeep * blockDim.x) + threadIdx.x, blockDim.x);
  list.start(a.nkeep, init);
  float self_d = init, d0 = init, best = CUDART_INF_F;
  int self_idx = -1;

  for (int st = 0; st < W_t; ++st) {
    const Slot s = slot_geometry(a, b, hd, t, qh, qw, st, ref_h, ref_w);
    // the anchor: lexicographically first argmin of |dt| + |dh| + |dw|;
    // cand is this slot's candidate where it is the best so far
    int cand = -1;
    if (a.anchor) {
      float mh = CUDART_INF_F, mw = CUDART_INF_F;
      int ah = 0, aw = 0;
      for (int i = 0; i < ws; ++i) {
        const float dh = fabsf(__fsub_rn(lattice(s.ch, s.oh, s1, i), (float)ref_h));
        if (dh < mh) { mh = dh; ah = i; }
        const float dw = fabsf(__fsub_rn(lattice(s.cw, s.ow, s1, i), (float)ref_w));
        if (dw < mw) { mw = dw; aw = i; }
      }
      const float tot = __fadd_rn(__fadd_rn(fabsf((float)(s.tj - tq)), mh), mw);
      if (tot < best) {
        best = tot;
        self_idx = cand = (st * ws + ah) * ws + aw;
      }
    }
    const float* v1 = a.vid1 + (bhd_v + s.tj) * FHW;
    for (int wi = 0; wi < ws; ++wi) {
      const float ph0 = lattice(s.ch, s.oh, s1, wi);
      const bool vh = inb_f(ph0, H);
      for (int wj = 0; wj < ws; ++wj) {
        const float pw0 = lattice(s.cw, s.ow, s1, wj);
        const int c = (st * ws + wi) * ws + wj;
        float d = init;
        if (vh && inb_f(pw0, W)) d = patch_dist(a, v1, qp, ph0, pw0);
        if (c == cand) self_d = d;
        if (a.anchor && c == 0) {   // competes at the end, under self_idx
          d0 = d;
          continue;
        }
        list.insert(a.l2, d, c);
      }
    }
  }

  float* od = a.dists + q * a.K;
  int* oc = a.cells + q * a.K;
  if (a.anchor) {
    if (self_idx != 0) {
      list.remove(self_idx);
      list.insert(a.l2, d0, self_idx);
    }
    od[0] = self_d;
    oc[0] = self_idx;
    ++od;
    ++oc;
  }
  list.write(od, oc, nslots, self_idx);
}

template <int PS, int FC>
cudaError_t launch(const NlsArgs& a, cudaStream_t stream) {
  const long long nq = (long long)a.B * a.HD * a.T * a.nH * a.nW;
  if (nq == 0) return cudaSuccess;
  const unsigned blocks = (unsigned)((nq + THREADS - 1) / THREADS);
  const size_t smem = 2 * sizeof(float) * a.nkeep * THREADS;
  const cudaError_t err = cudaFuncSetAttribute(
      nls_topk_kernel<PS, FC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  nls_topk_kernel<PS, FC><<<blocks, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// The (ps, F a head) pairs with ps and F compiled in, the one list of
// them: ps=3 with 8 channels a head is what bench.py, __graft_entry__ and
// examples/attn_example.py run (at 16, the compiled body was no faster);
// ps=1 with 2 is the 1080p alignment search of benchmarks/matrix.py
// configs 5 and 7. Every other pair, and every pair when `compiled` is 0,
// runs the run-time body <0, 0>.
#define STNLS_NLS_COMPILED(X) X(3, 8) X(1, 2)

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
  a.nkeep = anchor ? nslots + 1 : nslots;
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
