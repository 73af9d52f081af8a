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
//   - The swept bodies (STNLS_NLS_SWEPT: float keys, stride1 1, dilation
//     1, ps and ws compiled in, F at run time) cut the loads a term: on
//     such a lattice the (cell column, tap column) pairs with one sum
//     wj + pj read the same two corner columns with the same weights, so
//     each (cell row, tap row, channel) loads two key rows of ws + ps
//     columns once into registers, interpolates each column once and
//     adds all ws * ps terms from them (SweptCols, sweep_slot): at (3, 9)
//     27 loads serve 27 terms where the per-cell loop makes 135. On the
//     denoiser's 540p search it ran 68.3 ms where the run-time body ran
//     183.3, and 246.3 before that body's register budget was raised
//     (RUN_TIME_MIN_BLOCKS, PERF.md).
// Sums run in the plain version's order without FMAs (nls_common.cuh), so
// the dists are the plain volume's bitwise; no tensor cores, since wgmma
// would reassociate the sums. No allocation; no atomics but the optional
// slot counts; deterministic.

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
  unsigned long long* stats;  // null, or the slot counts (stnls_nls_topk_fwd)
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

// The swept bodies' column geometry of one time slot. In exact arithmetic
// the key column of tap column pj of cell column wj is that of m = wj + pj
// alone, so the slot reads the corner columns col0 .. col0 + ws + ps - 1
// of each key row. swept_cols holds every pair to that on the positions
// the per-cell loop computes (lattice, + (pj + po), reflect_f) and on
// their axis corners, so that the sweep reads the same corners with the
// same weights, bitwise:
//   - variant A: corner column col0 + m, the centre pair's weights;
//   - variant B (bit in mb): the same column, a second pair of weights.
//     Where a window crosses a power of two, the adds round the positions
//     beyond it by a tie, the same way for every integer added, so their
//     weights differ from the others' by one ulp;
//   - an exception (bit in mx): anything else, such as a tap reflected at
//     a border or a position on the last column (its second corner
//     clamped); the sweep sums it from its own corners (exception_sum),
//     as the per-cell loop reads it.
// A slot with a cell or a tap outside the frame (full_ws off, a tap beyond
// one reflection) is not swept (ok false) and takes the per-cell loop.
template <int PS, int SW>
struct SweptCols {
  int col0;                // corner column of tap position m = 0
  float a0, a1, b0, b1;    // column weights of variants A and B
  unsigned mb, mx;         // bits pj * SW + wj: variant B, exception
  bool ok;
};

// Column of tap column pj of cell column wj, as the per-cell loop forms it
__device__ __forceinline__ float tap_col(const NlsArgs& a, const Slot& s, int wj,
                                         int pj, int po) {
  return reflect_f(__fadd_rn(lattice(s.cw, s.ow, a.stride1, wj),
                             (float)(a.dilation * (pj + po))), a.W);
}

__device__ __forceinline__ bool same_bits(float x, float y) {
  return __float_as_uint(x) == __float_as_uint(y);
}

template <int PS, int SW>
__device__ __forceinline__ SweptCols<PS, SW> swept_cols(const NlsArgs& a, const Slot& s) {
  static_assert(PS * SW <= 32, "one bit a (wj, pj) pair");
  const int W = a.W;
  const int po = a.use_adj ? 0 : -(PS / 2);
  SweptCols<PS, SW> c;
  const AxisCorner ref = axis_corner(tap_col(a, s, SW / 2, PS / 2, po), W);
  c.col0 = ref.i0 - (SW / 2 + PS / 2);
  c.a0 = ref.w0;
  c.a1 = ref.w1;
  c.b0 = c.b1 = -1.f;   // no variant B yet: weights are never negative
  c.mb = c.mx = 0u;
  c.ok = true;
#pragma unroll
  for (int wj = 0; wj < SW; ++wj) {
    c.ok = c.ok && inb_f(lattice(s.cw, s.ow, a.stride1, wj), W);
#pragma unroll
    for (int pj = 0; pj < PS; ++pj) {
      const float p = tap_col(a, s, wj, pj, po);
      c.ok = c.ok && inb_f(p, W);
      const AxisCorner k = axis_corner(p, W);
      const unsigned bit = 1u << (pj * SW + wj);
      if (!(k.ok1 && k.i0 == c.col0 + wj + pj)) {
        c.mx |= bit;
        continue;
      }
      if (same_bits(k.w0, c.a0) && same_bits(k.w1, c.a1)) continue;
      if (c.b0 < 0.f) {
        c.b0 = k.w0;
        c.b1 = k.w1;
      }
      if (same_bits(k.w0, c.b0) && same_bits(k.w1, c.b1))
        c.mb |= bit;
      else
        c.mx |= bit;
    }
  }
  return c;
}

// One interpolated key value, in patch_dist's order
__device__ __forceinline__ float bilinear(float w00, float w01, float w10, float w11,
                                          float p00, float p01, float p10, float p11) {
  float p1 = __fmul_rn(w00, p00);
  p1 = __fadd_rn(p1, __fmul_rn(w01, p01));
  p1 = __fadd_rn(p1, __fmul_rn(w10, p10));
  return __fadd_rn(p1, __fmul_rn(w11, p11));
}

// One pass of the sweep over the channels of a (cell row, tap row): a
// channel at a time, the two key rows r0, r1 of SW + PS columns from col0
// loaded into registers, each column interpolated once with the weights
// w, each term added into sum[pj][wj] in patch_dist's order. MASKED adds
// only the pairs whose bit is in `keep` and clamps the loads to the frame
// (col0's range may leave it where a pair is an exception).
template <int PS, int SW, bool MASKED>
__device__ __forceinline__ void sweep_pass(const NlsArgs& a, const float* r0, const float* r1,
                                           int col0, float w00, float w01, float w10,
                                           float w11, const GlobalQuery& qp,
                                           const GlobalQuery::Tap (&qt)[PS],
                                           const bool (&qok)[PS], unsigned keep,
                                           float (&sum)[PS][SW]) {
  constexpr int NC = SW + PS;   // corner columns a row
  const long long HW = (long long)a.H * a.W;
#pragma unroll 1
  for (int f = 0; f < a.F; ++f, r0 += HW, r1 += HW) {
    float x0[NC], x1[NC];
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const int col = MASKED ? min(max(col0 + n, 0), a.W - 1) : col0 + n;
      x0[n] = __ldg(r0 + col);
      x1[n] = __ldg(r1 + col);
    }
    float q[PS];
#pragma unroll
    for (int pj = 0; pj < PS; ++pj) q[pj] = qok[pj] ? qp.val(qt[pj], f, HW) : 0.f;
    // column m at a time: its interpolated value and the (pj, wj) pairs
    // with wj + pj = m, so that one value is live at a time
#pragma unroll
    for (int m = 0; m < NC - 1; ++m) {
      const float p1 = bilinear(w00, w01, w10, w11, x0[m], x0[m + 1], x1[m], x1[m + 1]);
#pragma unroll
      for (int pj = 0; pj < PS; ++pj) {
        const int wj = m - pj;
        if (wj < 0 || wj >= SW) continue;
        const float df = q[pj] - p1;
        const float t = a.l2 ? __fmul_rn(df, df) : __fmul_rn(q[pj], p1);
        if (!MASKED || ((keep >> (pj * SW + wj)) & 1u)) sum[pj][wj] = __fadd_rn(sum[pj][wj], t);
      }
    }
  }
}

// The sum over the channels of one exception pair (bit pj * SW + wj) of a
// (cell row, tap row) with row corners h, read from the pair's own
// corners as patch_dist reads it; 0 for a query tap outside the frame.
template <int PS, int SW>
__device__ __forceinline__ float exception_sum(const NlsArgs& a, const Slot& s,
                                            const AxisCorner& h, const float* r0,
                                            const float* r1, const GlobalQuery& qp, int pi,
                                            int bit) {
  const long long HW = (long long)a.H * a.W;
  const int po = a.use_adj ? 0 : -(PS / 2);
  const int pj = bit / SW, wj = bit - pj * SW;
  GlobalQuery::Tap qh;
  if (!qp.tap(a, pi, pj, &qh)) return 0.f;   // a tap patch_dist skips
  const AxisCorner w = axis_corner(tap_col(a, s, wj, pj, po), a.W);
  const float w00 = h.w0 * w.w0, w01 = w.ok1 ? h.w0 * w.w1 : 0.f;
  const float w10 = h.ok1 ? h.w1 * w.w0 : 0.f, w11 = (h.ok1 && w.ok1) ? h.w1 * w.w1 : 0.f;
  float x = 0.f;
  for (int f = 0; f < a.F; ++f, r0 += HW, r1 += HW) {
    const float k = bilinear(w00, w01, w10, w11, r0[w.i0], r0[w.i1], r1[w.i0], r1[w.i1]);
    const float q = qp.val(qh, f, HW);
    const float df = q - k;
    x = __fadd_rn(x, a.l2 ? __fmul_rn(df, df) : __fmul_rn(q, k));
  }
  return x;
}

// The cells of time slot st on its column geometry cs, a row at a time:
// take(cell, dist) for each in the per-cell loop's order, each dist summed
// as patch_dist sums it (taps in order, channels inner, one rounded add at
// a time). The sweep runs one pass of variant A; MIXED runs variant A's
// pairs, then variant B's with B's weights, then the exceptions.
template <int PS, int SW, bool MIXED, class Take>
__device__ __forceinline__ void sweep_slot(const NlsArgs& a, const float* v1,
                                           const GlobalQuery& qp, const Slot& s,
                                           const SweptCols<PS, SW>& cs, int st,
                                           Take& take) {
  const int H = a.H, W = a.W;
  const int po = a.use_adj ? 0 : -(PS / 2);
#pragma unroll 1
  for (int wi = 0; wi < SW; ++wi) {
    const float ph0 = lattice(s.ch, s.oh, a.stride1, wi);
    const int c0 = (st * SW + wi) * SW;
    if (!inb_f(ph0, H)) {
#pragma unroll
      for (int wj = 0; wj < SW; ++wj) take(c0 + wj, a.l2 ? CUDART_INF_F : -CUDART_INF_F);
      continue;
    }
    float acc[SW];
#pragma unroll
    for (int wj = 0; wj < SW; ++wj) acc[wj] = 0.f;
#pragma unroll 1
    for (int pi = 0; pi < PS; ++pi) {
      const float ph = reflect_f(__fadd_rn(ph0, (float)(a.dilation * (pi + po))), H);
      if (!inb_f(ph, H)) continue;
      const AxisCorner h = axis_corner(ph, H);
      GlobalQuery::Tap qt[PS];
      bool qok[PS];
#pragma unroll
      for (int pj = 0; pj < PS; ++pj) qok[pj] = qp.tap(a, pi, pj, &qt[pj]);
      float sum[PS][SW];
#pragma unroll
      for (int pj = 0; pj < PS; ++pj)
#pragma unroll
        for (int wj = 0; wj < SW; ++wj) sum[pj][wj] = 0.f;
      const float* r0 = v1 + (long long)h.i0 * W;
      const float* r1 = v1 + (long long)h.i1 * W;
      const float a00 = h.w0 * cs.a0, a01 = h.w0 * cs.a1;
      const float a10 = h.ok1 ? h.w1 * cs.a0 : 0.f, a11 = h.ok1 ? h.w1 * cs.a1 : 0.f;
      if (!MIXED) {
        sweep_pass<PS, SW, false>(a, r0, r1, cs.col0, a00, a01, a10, a11, qp, qt, qok, ~0u,
                                  sum);
      } else {
        sweep_pass<PS, SW, true>(a, r0, r1, cs.col0, a00, a01, a10, a11, qp, qt, qok,
                                 ~(cs.mb | cs.mx), sum);
        if (cs.mb) {
          const float b00 = h.w0 * cs.b0, b01 = h.w0 * cs.b1;
          const float b10 = h.ok1 ? h.w1 * cs.b0 : 0.f, b11 = h.ok1 ? h.w1 * cs.b1 : 0.f;
          sweep_pass<PS, SW, true>(a, r0, r1, cs.col0, b00, b01, b10, b11, qp, qt, qok,
                                   cs.mb, sum);
        }
        for (unsigned mx = cs.mx; mx; mx &= mx - 1) {
          const int bit = __ffs(mx) - 1;
          const float x = exception_sum<PS, SW>(a, s, h, r0, r1, qp, pi, bit);
#pragma unroll
          for (int pj = 0; pj < PS; ++pj)
#pragma unroll
            for (int wj = 0; wj < SW; ++wj)
              if (pj * SW + wj == bit) sum[pj][wj] = x;
        }
      }
#pragma unroll
      for (int pj = 0; pj < PS; ++pj) {
        if (!qok[pj]) continue;
#pragma unroll
        for (int wj = 0; wj < SW; ++wj) acc[wj] = __fadd_rn(acc[wj], sum[pj][wj]);
      }
    }
#pragma unroll
    for (int wj = 0; wj < SW; ++wj) take(c0 + wj, acc[wj]);
  }
}

// Counts of the time slots by the loop that ran them (stats): [0] the
// sweep, [1] the per-cell loop, [2] the mixed sweep (a warp takes it for
// all its lanes where one lane needs it); [3] is left alone.
enum { kSwept = 0, kPerCell = 1, kMixed = 2, kCounts = 3 };

// One query of B1, its thread's: the slot geometry, the anchor, the ranked
// list and the output. SW = 0: the per-cell bodies, PS, FC > 0 compiled in
// or (0, 0) taken from the arguments, every cell summed by patch_dist.
// SW > 0: the swept body at ps = PS, ws = SW, F at run time: each time slot
// swept where swept_cols allows and on the per-cell loop elsewhere,
// counted into n.
template <int PS, int FC, int SW>
__device__ __forceinline__ void nls_query(const NlsArgs& a, long long q, int* n) {
  const int qw = (int)(q % a.nW);
  long long r = q / a.nW;
  const int qh = (int)(r % a.nH);
  r /= a.nH;
  const int t = (int)(r % a.T);
  r /= a.T;
  const int hd = (int)(r % a.HD);
  const int b = (int)(r / a.HD);

  const int H = a.H, W = a.W, ws = SW > 0 ? SW : a.ws;
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
    if constexpr (SW > 0) {
      const SweptCols<PS, SW> cs = swept_cols<PS, SW>(a, s);
      const bool one = cs.ok && (cs.mb | cs.mx) == 0u;
      // the warp takes the mixed sweep for all its swept lanes where one of
      // them needs it, rather than both sweeps one after the other
      const bool warp_one = __all_sync(__activemask(), one || !cs.ok);
      if (cs.ok) {
        auto take = [&](int c, float d) {
          if (c == cand) self_d = d;
          if (a.anchor && c == 0) {   // competes at the end, under self_idx
            d0 = d;
            return;
          }
          list.insert(a.l2, d, c);
        };
        if (warp_one) {
          sweep_slot<PS, SW, false>(a, v1, qp, s, cs, st, take);
          ++n[kSwept];
        } else {
          sweep_slot<PS, SW, true>(a, v1, qp, s, cs, st, take);
          ++n[kMixed];
        }
        continue;
      }
      ++n[kPerCell];
    }
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

// The compiled bodies: ps = PS and F = FC compiled in.
template <int PS, int FC>
__global__ void __launch_bounds__(THREADS) nls_topk_kernel(NlsArgs a) {
  const long long nq = (long long)a.B * a.HD * a.T * a.nH * a.nW;
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= nq) return;
  nls_query<PS, FC, 0>(a, q, nullptr);
}

// Adds the block's counts to stats: one atomic a count a block
__device__ __forceinline__ void add_counts(unsigned long long* stats, const int (&n)[kCounts]) {
  __shared__ unsigned int blk[kCounts];
  if (threadIdx.x < kCounts) blk[threadIdx.x] = 0u;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kCounts; ++i) {
    const unsigned s = __reduce_add_sync(0xffffffffu, (unsigned)n[i]);
    if ((threadIdx.x & 31) == 0 && s) atomicAdd(&blk[i], s);
  }
  __syncthreads();
  if (threadIdx.x < kCounts && blk[threadIdx.x])
    atomicAdd(stats + threadIdx.x, (unsigned long long)blk[threadIdx.x]);
}

// Blocks an SM the bodies with F at run time are compiled for. The swept
// ones: 4 caps them at 128 registers (16 warps an SM); at (3, 9) on the
// denoiser's 540p arguments 4 ran 70.3 ms, 3 (168 registers) 73.5, 2 (191)
// 89.7. The run-time body: 2 gives it 138 registers (12 warps an SM, 3 the
// same), where with no minimum it took 96 (20 warps) and ran 246.3 ms at
// the denoiser's arguments and 2.89 at an RVRT alignment's against 183.3
// and 2.05; 4 (128 registers) ran 196.8 and 2.32 (PERF.md).
constexpr int SWEPT_MIN_BLOCKS = 4;
constexpr int RUN_TIME_MIN_BLOCKS = 2;

// The bodies that take F at run time, FC = 0: the swept bodies <PS, 0, SW>
// (STNLS_NLS_SWEPT), their slots counted into a.stats, and the run-time
// body <0, 0, 0>, ps too at run time. The swept bodies are kernels apart
// from the compiled ones so that those keep their code: one kernel for
// both compiled the compiled bodies to other register counts, and the
// 1080p search's (1, 2) ran 14% slower (PERF.md).
template <int PS, int FC, int SW>
__global__ void __launch_bounds__(THREADS, SW > 0 ? SWEPT_MIN_BLOCKS : RUN_TIME_MIN_BLOCKS)
    nls_topk_kernel(NlsArgs a) {
  static_assert(FC == 0 && (SW > 0 || PS == 0), "F at run time; ps too without a sweep");
  const long long nq = (long long)a.B * a.HD * a.T * a.nH * a.nW;
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  int n[kCounts] = {0, 0, 0};
  if (q < nq) nls_query<PS, 0, SW>(a, q, n);
  if constexpr (SW > 0) {
    if (a.stats) add_counts(a.stats, n);   // every thread of the block
  }
}

cudaError_t launch(void (*kernel)(NlsArgs), const NlsArgs& a, cudaStream_t stream) {
  const long long nq = (long long)a.B * a.HD * a.T * a.nH * a.nW;
  if (nq == 0) return cudaSuccess;
  const unsigned blocks = (unsigned)((nq + THREADS - 1) / THREADS);
  const size_t smem = 2 * sizeof(float) * a.nkeep * THREADS;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// The (ps, F a head) pairs with ps and F compiled in, the one list of
// them: ps=3 with 8 channels a head is what bench.py, __graft_entry__ and
// examples/attn_example.py run (at 16, the compiled body was no faster);
// ps=1 with 2 is the 1080p alignment search of benchmarks/matrix.py
// configs 5 and 7. Every other pair, and every pair when `compiled` is 0,
// runs the run-time body <0, 0, 0>.
#define STNLS_NLS_COMPILED(X) X(3, 8) X(1, 2)

// The (ps, ws) pairs with a swept body, the one list of them, for float
// keys at stride1 1 and dilation 1, any F: (3, 9) is the denoiser's search
// (NonLocalDenoiser, F 16 a head). Not listed, where the card ran the
// swept body slower: (1, 5), the 1080p alignment's, 98.9 ms against the
// compiled (1, 2) body's 77.1; (1, 9), RVRT's PairedSearch (prod, F 32 a
// head, 64^2 frames, most slots at a border), 2.50 against the run-time
// body's 2.05 (PERF.md). The entry chooses from what the call shows: a
// listed (ps, ws) on such a lattice takes its swept body, before the
// compiled list; `compiled` 0 takes the run-time body for it too.
#define STNLS_NLS_SWEPT(X) X(3, 9)

// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for more than KMAX ranked slots. `stats`, when not
// null and a swept body runs, gets the counts of the time slots of every
// query added, by the loop that ran them: [0] the sweep, [1] the per-cell
// loop, [2] the mixed sweep (variant B or exceptions). The per-cell bodies
// count nothing: every slot of theirs is on the per-cell loop.
extern "C" int stnls_nls_topk_fwd(
    const float* vid0, const float* vid1, const float* flows, float* dists,
    int* cells, unsigned long long* stats, int B, int HD, int T, int F,
    int H, int W, int HDf, int St, int nH, int nW, int Tv, int t0, int Tg,
    int halo, int ws, int wt, int ps, int stride0, int dilation,
    float stride1, float s1_half, int K, int anchor, int l2, int full_ws,
    int use_adj, int is_int, int compiled, void* stream_ptr) {
  NlsArgs a{vid0, vid1, flows, dists, cells, B, HD, T, F, H, W, HDf, St, nH, nW,
            Tv, t0, Tg, halo, ws, wt, ps, stride0, dilation, stride1, s1_half,
            K, anchor, l2, full_ws, use_adj, is_int};
  a.stats = stats;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int nslots = anchor ? K - 1 : K;
  if (nslots < 0 || nslots > KMAX) return (int)cudaErrorInvalidValue;
  a.nkeep = anchor ? nslots + 1 : nslots;
  const bool sweepable = compiled && !is_int && stride1 == 1.f && dilation == 1;
#define STNLS_SWEEP(P, S) \
  if (sweepable && ps == P && ws == S) return (int)launch(nls_topk_kernel<P, 0, S>, a, stream);
  STNLS_NLS_SWEPT(STNLS_SWEEP)
#undef STNLS_SWEEP
#define STNLS_LAUNCH(P, FC) \
  if (compiled && ps == P && F == FC) return (int)launch(nls_topk_kernel<P, FC>, a, stream);
  STNLS_NLS_COMPILED(STNLS_LAUNCH)
#undef STNLS_LAUNCH
  return (int)launch(nls_topk_kernel<0, 0, 0>, a, stream);
}

// 1 when (ps, F) has a body with ps and F compiled in, else 0.
extern "C" int stnls_nls_topk_compiled(int ps, int F) {
#define STNLS_HAS(P, FC) if (ps == P && F == FC) return 1;
  STNLS_NLS_COMPILED(STNLS_HAS)
#undef STNLS_HAS
  return 0;
}

// 1 when (ps, ws) has a swept body, else 0.
extern "C" int stnls_nls_topk_swept(int ps, int ws) {
#define STNLS_HAS(P, S) if (ps == P && ws == S) return 1;
  STNLS_NLS_SWEPT(STNLS_HAS)
#undef STNLS_HAS
  return 0;
}
