// B4: NonLocalGather backward, for Hopper.
//
// Replaces the Pallas TPU kernel stnls_tpu/ops/agg_pallas_bwd.py:
// _make_bwd_kernel (entry agg_bwd_pallas, the backward of the custom_vjp
// _agg_op). Plain version: stnls_tpu_torch/ops/agg_cuda.py::
// _gather_bwd_plain, the VJP of the plain gather
// (stnls_tpu_torch/ops/agg.py::nl_gather_stack).
//
// What it computes, from the stack cotangent g [B,HD,K,T,F,H,W] of the
// count-normalised forward (csrc/agg_gather_fwd.cu), for every query q and
// slot k: with gs = g / (overlap count + 1e-10) at the reference pixel
// (y, x) of each patch tap that lies in the frame, and pv the value the
// forward read there (bilinear for float, at reflected corners),
//   g_weights[q,k]  = sum over taps, pt and channels of gs * pv,
//   g_vid          += gs * w[q,k] * corner weight at each corner's source
//                     pixel (the transpose of the forward's reads),
//   g_flows[q,k]    = (0, dh, dw): the bilinear corner derivatives times
//                     gs * w, with the sign of the centre's reflection;
//                     dt and the whole int path get 0.
//
// What bounds it on the H100: the scatter into g_vid. At the slice config
// (163,840 queries, K=10, ps=3, F=8) one backward adds 9 taps x 8
// channels x 4 corners per (q, k), about 4.7e8 float adds at data-
// dependent bilinear positions, against a 52 MB cotangent read once. As
// global atomics (the first version of this kernel) they ran at 138x the
// byte bound. A gather form, one thread per video element, does not fit:
// the adds land at positions the offsets choose, so a video element
// could list its contributors only through an inverse index of every
// (q, k, tap) (~59 M entries at the slice).
//
// What the design does about it: one block takes a TQH x TQW tile of
// queries of one (b, hd, t), one thread per query, all K slots.
//   Sweep 1 reduces, per destination frame, the bounding box of the
//     bilinear corners that the tile's (q, k) reach (shared atomicMin /
//     atomicMax). Smooth flows keep the tile's slots in a few frames, each
//     box about the tile plus the flow spread, the window, ps and 1. The
//     boxes are allotted in shared memory times a channel group Fg (as
//     many channels as the pool holds); a frame whose box does not fit
//     the pool takes the global path below.
//   Sweep 2, once per channel group, adds gs * w * corner weight into the
//     boxes with shared atomics; an entry whose frame got no box adds
//     straight to g_vid with global atomics, the same exact sum (counted
//     when the caller asks for the counts). Zero terms are not added: an
//     entry of weight 0 (softmax(-10 d) underflows for most slots of a
//     step whose q = k) takes no box and no add, and sums g_weights only.
//   Flush: each non-zero box element adds once to g_vid (global atomic:
//     neighbouring tiles' boxes overlap). At the slice this is ~9.3e6
//     global atomics a backward in place of ~4.7e8.
// Hopper has no native float add into shared memory: atomicAdd and
// red.shared.add.f32 both compile to a compare-and-swap loop
// (ATOMS.CAST.SPIN in the SASS), which is now the largest cost of the
// kernel; summing an interior patch's corners in registers first (16 adds
// in place of 36 at ps=3) measured no faster (PERF.md).
// The overlap counts are tabled once per reference row and column of the
// tile; the division g / (count + 1e-10) is the plain version's. Each
// thread sums g_weights and g_flows of its (q, k) in registers in a fixed
// order and writes them (deterministic). g_vid depends on the order of
// the atomics and is not bitwise deterministic.

#include <cuda_runtime.h>
#include <limits.h>

namespace {

constexpr int TQH = 16, TQW = 16, NT = TQH * TQW;   // the query tile
// floats of the box pool: 96 KB, two blocks an SM
constexpr int POOL_FLOATS = 24576;

struct AggBwdArgs {
  const float* vid;      // [B,HD,T,F,H,W]
  const float* weights;  // [B,HD,T,nH,nW,K]
  const float* flows;    // [B,HD,T,nH,nW,K,3] as (dt, dh, dw)
  const float* g_stack;  // [B,HD,K,T,F,H,W]
  float* g_vid;          // [B,HD,T,F,H,W], zeroed by the caller
  float* g_weights;      // [B,HD,T,nH,nW,K]
  float* g_flows;        // [B,HD,T,nH,nW,K,3]
  unsigned long long* stats;  // null, or the counts (stnls_agg_gather_bwd)
  int B, HD, K, T, F, H, W, nH, nW;
  int ps, stride0, pt, dilation, use_adj, is_int;
  int ny, nx;            // rows and columns of the tile's count tables
};

__device__ __forceinline__ int reflect_i(int v, int lim) {
  int out = v < 0 ? -v : v;
  out = v > lim - 1 ? 2 * (lim - 1) - v : out;
  return min(max(out, 0), lim - 1);
}

__device__ __forceinline__ float reflect_f(float v, int lim) {
  float out = v < 0.f ? -v : v;
  return v > (float)(lim - 1) ? __fsub_rn((float)(2 * (lim - 1)), v) : out;
}

// derivative of reflect_f: -1 where the value was folded back
__device__ __forceinline__ float reflect_sign(float v, int lim) {
  return (v < 0.f || v > (float)(lim - 1)) ? -1.f : 1.f;
}

// number of queries whose tap covers position pos along one axis
__device__ __forceinline__ int fold_count(int pos, const AggBwdArgs& a, int n, int po) {
  int c = 0;
  for (int p = 0; p < a.ps; ++p) {
    const int d = pos - a.dilation * (p + po);
    c += d >= 0 && d % a.stride0 == 0 && d / a.stride0 < n;
  }
  return c;
}

// The geometry of one (query, slot): its weight, frame, and the first
// bilinear corner of its first tap with the fractions and the signs of the
// centre's reflection.
struct Entry {
  float w, fh, fw, sgn_h, sgn_w;
  int nl_t, i0, j0;
};

__device__ __forceinline__ Entry entry_geometry(const AggBwdArgs& a, long long e,
                                                int t, int qh, int qw, int po) {
  Entry n;
  n.w = a.weights[e];
  const float* fl = a.flows + e * 3;
  n.nl_t = reflect_i(t + (int)rintf(fl[0]), a.T);
  const int dil = a.dilation;
  n.fh = n.fw = n.sgn_h = n.sgn_w = 0.f;
  if (a.is_int) {
    n.i0 = reflect_i(qh * a.stride0 + (int)rintf(fl[1]), a.H) + dil * po;
    n.j0 = reflect_i(qw * a.stride0 + (int)rintf(fl[2]), a.W) + dil * po;
  } else {
    const float raw_h = __fadd_rn((float)(qh * a.stride0), fl[1]);
    const float raw_w = __fadd_rn((float)(qw * a.stride0), fl[2]);
    n.sgn_h = reflect_sign(raw_h, a.H);
    n.sgn_w = reflect_sign(raw_w, a.W);
    const float o_h = __fadd_rn(reflect_f(raw_h, a.H), (float)(dil * po));
    const float o_w = __fadd_rn(reflect_f(raw_w, a.W), (float)(dil * po));
    const float fi = floorf(o_h), fj = floorf(o_w);
    n.fh = __fsub_rn(o_h, fi);
    n.fw = __fsub_rn(o_w, fj);
    n.i0 = (int)fi;
    n.j0 = (int)fj;
  }
  return n;
}

// A float add into g_vid's box (shared) or g_vid (global); a zero adds
// nothing and is skipped, which leaves the sums exact
__device__ __forceinline__ void add_nonzero(float* p, float v) {
  if (v != 0.f) atomicAdd(p, v);
}

// A frame's box in shared memory: rows r0..r1, columns c0..c1, and its
// offset into the pool (-1: the frame takes the global path).
struct Box {
  int r0, r1, c0, c1, base;
};

__device__ __forceinline__ int box_area(const Box& b) {
  return b.r1 < b.r0 ? 0 : (b.r1 - b.r0 + 1) * (b.c1 - b.c0 + 1);
}

// Shared memory: the pool, then T boxes, then the count tables (ny rows,
// nx columns), then the block's channel group and counts.
__global__ void __launch_bounds__(NT) agg_gather_bwd_tile_kernel(AggBwdArgs a) {
  extern __shared__ float smem[];
  float* pool = smem;
  Box* box = reinterpret_cast<Box*>(smem + POOL_FLOATS);
  int* cnt_h = reinterpret_cast<int*>(box + a.T);
  int* cnt_w = cnt_h + a.ny;
  int* fg_s = cnt_w + a.nx;                        // channel group
  unsigned long long* cnt_s = reinterpret_cast<unsigned long long*>(
      (reinterpret_cast<size_t>(fg_s + 1) + 7) & ~size_t(7));

  const int tid = threadIdx.x;
  const int qh0 = blockIdx.y * TQH, qw0 = blockIdx.x * TQW;
  const int qh = qh0 + tid / TQW, qw = qw0 + tid % TQW;
  const int t = blockIdx.z % a.T;
  const long long bhd = blockIdx.z / a.T;
  const bool active = qh < a.nH && qw < a.nW;
  const int H = a.H, W = a.W, T = a.T, dil = a.dilation, K = a.K;
  const long long HW = (long long)H * W;
  const int F = a.F;
  const int po = a.use_adj ? 0 : -(a.ps / 2);
  const int y0 = qh0 * a.stride0 + dil * po, x0 = qw0 * a.stride0 + dil * po;
  const long long e0 = ((bhd * T + t) * a.nH + qh) * (long long)a.nW + qw;

  for (int i = tid; i < T; i += NT) box[i] = Box{INT_MAX, INT_MIN, INT_MAX, INT_MIN, -1};
  for (int i = tid; i < a.ny; i += NT) cnt_h[i] = fold_count(y0 + i, a, a.nH, po);
  for (int i = tid; i < a.nx; i += NT) cnt_w[i] = fold_count(x0 + i, a, a.nW, po);
  if (tid < 4) cnt_s[tid] = 0;
  __syncthreads();

  // sweep 1: the boxes of the destination frames
  if (active) {
    for (int k = 0; k < K; ++k) {
      const Entry n = entry_geometry(a, e0 * K + k, t, qh, qw, po);
      if (n.w == 0.f) continue;   // adds nothing to g_vid
      int r_lo = INT_MAX, r_hi = INT_MIN, c_lo = INT_MAX, c_hi = INT_MIN;
      for (int pi = 0; pi < a.ps; ++pi) {
        const int y = qh * a.stride0 + dil * (pi + po);
        if (y < 0 || y >= H) continue;
        const int ra = reflect_i(n.i0 + dil * pi, H);
        const int rb = a.is_int ? ra : reflect_i(n.i0 + dil * pi + 1, H);
        r_lo = min(r_lo, min(ra, rb));
        r_hi = max(r_hi, max(ra, rb));
      }
      for (int pj = 0; pj < a.ps; ++pj) {
        const int x = qw * a.stride0 + dil * (pj + po);
        if (x < 0 || x >= W) continue;
        const int ca = reflect_i(n.j0 + dil * pj, W);
        const int cb = a.is_int ? ca : reflect_i(n.j0 + dil * pj + 1, W);
        c_lo = min(c_lo, min(ca, cb));
        c_hi = max(c_hi, max(ca, cb));
      }
      if (r_hi < r_lo || c_hi < c_lo) continue;
      for (int pk = 0; pk < a.pt; ++pk) {
        Box* b = box + reflect_i(n.nl_t + pk, T);
        atomicMin(&b->r0, r_lo);
        atomicMax(&b->r1, r_hi);
        atomicMin(&b->c0, c_lo);
        atomicMax(&b->c1, c_hi);
      }
    }
  }
  __syncthreads();

  // allot the boxes: Fg channels each, as many as the pool holds; frames
  // beyond the pool take the global path
  if (tid == 0) {
    long long total = 0;
    for (int f = 0; f < T; ++f) total += box_area(box[f]);
    int fg = total > 0 ? (int)min((long long)F, max(1LL, POOL_FLOATS / total)) : F;
    int off = 0;
    for (int f = 0; f < T; ++f) {
      const int area = box_area(box[f]);
      if (area > 0 && off + area * fg <= POOL_FLOATS) {
        box[f].base = off;
        off += area * fg;
      }
    }
    *fg_s = fg;
  }
  __syncthreads();
  const int fg = *fg_s;

  unsigned long long n_direct = 0, n_global_entries = 0;
  for (int f0 = 0; f0 < F; f0 += fg) {
    const int f1 = min(F, f0 + fg);
    for (int f = 0; f < T; ++f) {
      if (box[f].base < 0) continue;
      const int n = box_area(box[f]) * fg;
      for (int i = tid; i < n; i += NT) pool[box[f].base + i] = 0.f;
    }
    __syncthreads();

    // sweep 2: this channel group's adds, into the boxes or g_vid
    if (active) {
      for (int k = 0; k < K; ++k) {
        const long long e = e0 * K + k;
        const Entry n = entry_geometry(a, e, t, qh, qw, po);
        const float w00 = (1.f - n.fh) * (1.f - n.fw), w01 = (1.f - n.fh) * n.fw;
        const float w10 = n.fh * (1.f - n.fw), w11 = n.fh * n.fw;
        const float* gst = a.g_stack + ((bhd * K + k) * T + t) * F * HW;
        // a zero weight (common: softmax(-10 d) underflows) adds nothing to
        // g_vid or g_flows, and got no box; g_weights still sums
        const bool adds = n.w != 0.f;
        float gw = 0.f, gfh = 0.f, gfw = 0.f;
        bool went_global = false;
        for (int pk = 0; pk < a.pt; ++pk) {
          const int tj = reflect_i(n.nl_t + pk, T);
          const Box bx = box[tj];
          const int bw = bx.base >= 0 ? bx.c1 - bx.c0 + 1 : 0, area = box_area(bx);
          const float* v = a.vid + (bhd * T + tj) * F * HW;
          float* gv = a.g_vid + (bhd * T + tj) * F * HW;
          for (int pi = 0; pi < a.ps; ++pi) {
            const int y = qh * a.stride0 + dil * (pi + po);
            if (y < 0 || y >= H) continue;
            const int cnt_y = cnt_h[y - y0];
            const int r0 = reflect_i(n.i0 + dil * pi, H);
            const int r1 = reflect_i(n.i0 + dil * pi + 1, H);
            for (int pj = 0; pj < a.ps; ++pj) {
              const int x = qw * a.stride0 + dil * (pj + po);
              if (x < 0 || x >= W) continue;
              const float cnt = (float)(cnt_y * cnt_w[x - x0]) + 1e-10f;
              const long long og = (long long)y * W + x;
              const int c0 = reflect_i(n.j0 + dil * pj, W);
              const int c1 = reflect_i(n.j0 + dil * pj + 1, W);
              const long long o00 = (long long)r0 * W + c0, o01 = (long long)r0 * W + c1;
              const long long o10 = (long long)r1 * W + c0, o11 = (long long)r1 * W + c1;
              // box offsets of the four corners (int path: the first)
              int s00 = 0, s01 = 0, s10 = 0, s11 = 0;
              if (adds && bx.base >= 0) {
                s00 = (r0 - bx.r0) * bw + (c0 - bx.c0);
                s01 = (r0 - bx.r0) * bw + (c1 - bx.c0);
                s10 = (r1 - bx.r0) * bw + (c0 - bx.c0);
                s11 = (r1 - bx.r0) * bw + (c1 - bx.c0);
              } else if (adds) {
                went_global = true;
                n_direct += (unsigned long long)(f1 - f0) * (a.is_int ? 1 : 4);
              }
              for (int f = f0; f < f1; ++f) {
                const float gs = gst[f * HW + og] / cnt;
                const float* p = v + f * HW;
                float* sb = pool + (f - f0) * area + max(bx.base, 0);
                float* gp = gv + f * HW;
                if (a.is_int) {
                  gw += gs * p[o00];
                  if (adds) add_nonzero(bx.base >= 0 ? sb + s00 : gp + o00, gs * n.w);
                  continue;
                }
                const float c00 = p[o00], c01 = p[o01], c10 = p[o10], c11 = p[o11];
                gw += gs * (w00 * c00 + w01 * c01 + w10 * c10 + w11 * c11);
                if (!adds) continue;
                const float gsw = gs * n.w;
                if (bx.base >= 0) {
                  add_nonzero(sb + s00, gsw * w00);
                  add_nonzero(sb + s01, gsw * w01);
                  add_nonzero(sb + s10, gsw * w10);
                  add_nonzero(sb + s11, gsw * w11);
                } else {
                  add_nonzero(gp + o00, gsw * w00);
                  add_nonzero(gp + o01, gsw * w01);
                  add_nonzero(gp + o10, gsw * w10);
                  add_nonzero(gp + o11, gsw * w11);
                }
                gfh += gsw * ((1.f - n.fw) * (c10 - c00) + n.fw * (c11 - c01));
                gfw += gsw * ((1.f - n.fh) * (c01 - c00) + n.fh * (c11 - c10));
              }
            }
          }
        }
        if (f0 == 0) {
          a.g_weights[e] = gw;
          float* gf = a.g_flows + e * 3;
          gf[0] = 0.f;
          gf[1] = n.sgn_h * gfh;
          gf[2] = n.sgn_w * gfw;
        } else {
          a.g_weights[e] += gw;
          float* gf = a.g_flows + e * 3;
          gf[1] += n.sgn_h * gfh;
          gf[2] += n.sgn_w * gfw;
        }
        if (f0 == 0 && went_global) ++n_global_entries;
      }
    }
    __syncthreads();

    // flush: each non-zero box element once into g_vid
    unsigned long long n_flush = 0;
    for (int f = 0; f < T; ++f) {
      const Box bx = box[f];
      if (bx.base < 0) continue;
      const int bw = bx.c1 - bx.c0 + 1, area = box_area(bx);
      const int n = area * (f1 - f0);
      float* gv = a.g_vid + ((bhd * T + f) * F + f0) * HW;
      for (int i = tid; i < n; i += NT) {
        const float val = pool[bx.base + i];
        if (val == 0.f) continue;
        const int ch = i / area, rc = i - ch * area;
        const int r = bx.r0 + rc / bw, c = bx.c0 + rc % bw;
        atomicAdd(gv + ch * HW + (long long)r * W + c, val);
        ++n_flush;
      }
    }
    if (a.stats) atomicAdd(cnt_s, n_flush);
    __syncthreads();
  }

  if (a.stats) {
    atomicAdd(cnt_s + 1, n_direct);
    atomicAdd(cnt_s + 2, n_global_entries);
    if (active) atomicAdd(cnt_s + 3, (unsigned long long)K);
    __syncthreads();
    if (tid < 4) atomicAdd(a.stats + tid, cnt_s[tid]);
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success). `stats`, when
// not null, gets added: [0] the flush's global atomics, [1] the global
// atomics of entries whose frame got no box, [2] the (query, slot)
// entries that went to global memory so, [3] all (query, slot) entries.
extern "C" int stnls_agg_gather_bwd(
    const float* vid, const float* weights, const float* flows,
    const float* g_stack, float* g_vid, float* g_weights, float* g_flows,
    unsigned long long* stats,
    int B, int HD, int K, int T, int F, int H, int W, int nH, int nW, int ps,
    int stride0, int pt, int dilation, int use_adj, int is_int,
    void* stream_ptr) {
  const int ny = (TQH - 1) * stride0 + dilation * (ps - 1) + 1;
  const int nx = (TQW - 1) * stride0 + dilation * (ps - 1) + 1;
  AggBwdArgs a{vid, weights, flows, g_stack, g_vid, g_weights, g_flows, stats,
               B, HD, K, T, F, H, W, nH, nW, ps, stride0, pt, dilation,
               use_adj, is_int, ny, nx};
  if ((long long)B * HD * T * nH * nW == 0 || K == 0) return 0;
  const size_t smem = POOL_FLOATS * sizeof(float) + (size_t)T * sizeof(Box) +
                      (size_t)(ny + nx + 1) * sizeof(int) + 8 +
                      4 * sizeof(unsigned long long);
  if (smem > 232448 || (long long)B * HD * T > 65535) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      agg_gather_bwd_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((nW + TQW - 1) / TQW, (nH + TQH - 1) / TQH, B * HD * T);
  agg_gather_bwd_tile_kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream_ptr)>>>(a);
  return (int)cudaGetLastError();
}
