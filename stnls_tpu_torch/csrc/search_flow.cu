// F1 and F2: the search-flow walk and its flow backward, for Hopper.
//
// Replaces, on CUDA tensors, the torch walk of ops/flow_ops.search_flow: a
// Python loop over the W_t - 1 window slots that, slot by slot, copies the
// picked frames of fflow and bflow, samples them bilinearly at every
// query's current position (four gathers, reflected and clamped corners)
// and stacks the accumulated offsets. Plain version:
// stnls_tpu_torch/ops/flow_ops.py::search_flow_plain. It has no Pallas
// counterpart: the JAX package builds this walk in XLA.
//
// What F1 computes, per query (b, ti, qh, qw) of the stride0 grid: the walk
// of geometry.time_window_frames' boundary-shifted window. Slot si = 1 ..
// W_t - 1 targets frame tj; while tj runs past ti the walk moves along
// fflow (frame tj - 1's flow), and once the forward run has reached t_max it
// restarts from the query and moves along bflow (frame tj + 1's flow). Each
// step adds the flow sampled bilinearly at the current position, a corner
// outside the frame read at its reflected, clamped index; slot si - 1 of the
// output [B,T,W_t-1,2,nH,nW] holds (w - w_ref, h - h_ref).
//
// Bitwise equal to the plain walk on the card: every float operation is
// the plain walk's, in its order (floor, fraction, the corner weights
// 1 - |d - f| clamped at 0, their product, the sums started at 0 in corner
// order (0,0), (0,1), (1,0), (1,1), the step, the offset), each rounded on
// its own (__fmul_rn / __fadd_rn / __fsub_rn: nvcc may not contract them).
// The flows are finite, as the plain walk's integer conversion assumes.
//
// What bounds it on the H100: memory. At 1080p (T 10, wt 3: 6 slots) it
// writes 995 MB of offsets and reads the two 166 MB flow stacks: 0.40 ms at
// 3.35 TB/s. A query's walk is ~60 instructions a slot.
//
// What the design does about it:
//   - One launch walks every slot of every query in registers: no frame
//     copies, no intermediate planes, no host tables (a slot's target
//     frame, restart and flow are integer arithmetic on (ti, si, T, wt),
//     uniform across a block), and every output element is written once.
//   - A thread takes two neighbouring queries, so a slot's offsets leave
//     as float2 stores that a warp coalesces into contiguous rows, and the
//     two independent walks overlap their dependent loads.
//   - Neighbouring blocks take the same queries of every (b, ti) plane, so
//     the frames that nearby query frames share are read from DRAM once and
//     from L2 after; a smooth flow keeps a warp's corners on neighbouring
//     words, read through the read-only path (__ldg).
//
// F2, the flows' gradient: one thread per query walks the forward again
// (the sample positions bitwise F1's, SEG slots a pass held in registers,
// earlier passes walked again), then the slots backward: the cotangent of a
// slot's offset joins the position's gradient, which flows on through the
// step's identity and through the derivatives of the bilinear weights (the
// subgradients autograd gives through the plain walk: |x|' = sgn(x) with
// sgn(0) = 0, the clamp's gradient passed at 0); a restart cuts the chain.
// Each corner's weight times the position's gradient is added into the
// gradient of the flow it read (atomicAdd; either flow's may be absent).

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int QPT = 2;          // F1's queries a thread
constexpr int SEG = 8;          // F2's slots a pass

struct WalkArgs {
  const float* fflow;   // [B,T,2,H,W], channel 0 = w, 1 = h
  const float* bflow;
  const float* g_out;   // F2: [B,T,S,2,nH,nW]
  float* out;           // F1: [B,T,S,2,nH,nW]
  float* g_fflow;       // F2: [B,T,2,H,W] or null (no gradient)
  float* g_bflow;
  int B, T, H, W, nH, nW, wt, stride0, S;
};

// Slot si's step for query frame ti: restart from the query, walk along
// fflow, and the flow frame read (geometry.time_window_frames).
struct Slot {
  bool restart, fwd;
  int pick;
};

__device__ __forceinline__ Slot slot_of(int ti, int si, int T, int wt) {
  const int t_shift = min(0, ti - wt) + max(0, ti + wt - (T - 1));
  const int t_max = min(T - 1, ti + wt - t_shift);
  int tj = ti + si;
  if (tj > t_max) tj = t_max - si;
  Slot s;
  s.restart = ti + si - 1 == t_max;
  s.fwd = tj > ti;
  s.pick = s.fwd ? tj - 1 : tj + 1;
  return s;
}

// reflect_bounds(v, L) then clamped to [0, L-1], for v = i + d; i is the
// floored coordinate, first clamped to [-2L, 2L], where the result is the
// same and the conversion exact
__device__ __forceinline__ int corner(float i, int d, int L) {
  int v = __float2int_rz(fminf(fmaxf(i, -2.f * L), 2.f * L)) + d;
  const int r = v < 0 ? -v : v;
  v = v > L - 1 ? 2 * (L - 1) - v : r;
  return min(max(v, 0), L - 1);
}

// 1 - |d - f| clamped at 0: a corner's weight along one axis
__device__ __forceinline__ float weight(int d, float f) {
  return fmaxf(__fsub_rn(1.f, fabsf(__fsub_rn((float)d, f))), 0.f);
}

// d weight(d, f) / d f as autograd takes it through the plain walk
__device__ __forceinline__ float weight_grad(int d, float f) {
  const float u = __fsub_rn((float)d, f);
  if (__fsub_rn(1.f, fabsf(u)) < 0.f) return 0.f;
  return u > 0.f ? 1.f : u < 0.f ? -1.f : 0.f;
}

// The flow (dW, dH) of planes (pw, ph) [H*W each] sampled bilinearly at
// (h, w), as flow_ops._sample_flow.
__device__ __forceinline__ void sample(const float* __restrict__ pw,
                                       const float* __restrict__ ph, float h,
                                       float w, int H, int W, float* dW,
                                       float* dH) {
  const float h0 = floorf(h), w0 = floorf(w);
  const float fh = __fsub_rn(h, h0), fw = __fsub_rn(w, w0);
  const int c0 = corner(w0, 0, W), c1 = corner(w0, 1, W);
  const float ww0 = weight(0, fw), ww1 = weight(1, fw);
  float oW = 0.f, oH = 0.f;
#pragma unroll
  for (int di = 0; di < 2; ++di) {
    const int row = corner(h0, di, H) * W;
    const float wh = weight(di, fh);
    const float g0 = __fmul_rn(wh, ww0), g1 = __fmul_rn(wh, ww1);
    oW = __fadd_rn(oW, __fmul_rn(g0, __ldg(pw + row + c0)));
    oH = __fadd_rn(oH, __fmul_rn(g0, __ldg(ph + row + c0)));
    oW = __fadd_rn(oW, __fmul_rn(g1, __ldg(pw + row + c1)));
    oH = __fadd_rn(oH, __fmul_rn(g1, __ldg(ph + row + c1)));
  }
  *dW = oW;
  *dH = oH;
}

// grid: x = (chunk of THREADS * QPT queries) * B * T + (b, ti) plane
__global__ void __launch_bounds__(THREADS) search_flow_fwd_kernel(WalkArgs a) {
  const int BT = a.B * a.T;
  const int p = blockIdx.x % BT;
  const int ti = p % a.T, b = p / a.T;
  const int nq = a.nH * a.nW;
  const int q0 = ((blockIdx.x / BT) * THREADS + threadIdx.x) * QPT;
  if (q0 >= nq) return;
  const long long HW = (long long)a.H * a.W;
  float h_ref[QPT], w_ref[QPT], h[QPT], w[QPT];
#pragma unroll
  for (int u = 0; u < QPT; ++u) {
    const int q = min(q0 + u, nq - 1);
    const int qh = q / a.nW;
    h_ref[u] = h[u] = (float)(qh * a.stride0);
    w_ref[u] = w[u] = (float)((q - qh * a.nW) * a.stride0);
  }
  const bool pair = q0 + 1 < nq && (nq & 1) == 0;
  float* out = a.out + (long long)p * a.S * 2 * nq + q0;
  for (int si = 1; si <= a.S; ++si) {
    const Slot s = slot_of(ti, si, a.T, a.wt);
    const float* pw = (s.fwd ? a.fflow : a.bflow) + ((long long)b * a.T + s.pick) * 2 * HW;
    float ow[QPT], oh[QPT];
#pragma unroll
    for (int u = 0; u < QPT; ++u) {
      if (s.restart) {
        h[u] = h_ref[u];
        w[u] = w_ref[u];
      }
      float dW, dH;
      sample(pw, pw + HW, h[u], w[u], a.H, a.W, &dW, &dH);
      h[u] = __fadd_rn(h[u], dH);
      w[u] = __fadd_rn(w[u], dW);
      ow[u] = __fsub_rn(w[u], w_ref[u]);
      oh[u] = __fsub_rn(h[u], h_ref[u]);
    }
    float* o = out + (long long)(si - 1) * 2 * nq;
    if (pair) {
      *reinterpret_cast<float2*>(o) = make_float2(ow[0], ow[1]);
      *reinterpret_cast<float2*>(o + nq) = make_float2(oh[0], oh[1]);
    } else {
#pragma unroll
      for (int u = 0; u < QPT; ++u) {
        if (q0 + u < nq) {
          o[u] = ow[u];
          o[u + nq] = oh[u];
        }
      }
    }
  }
}

// grid: x = (chunk of THREADS queries) * B * T + (b, ti) plane
__global__ void __launch_bounds__(THREADS) search_flow_bwd_kernel(WalkArgs a) {
  const int BT = a.B * a.T;
  const int p = blockIdx.x % BT;
  const int ti = p % a.T, b = p / a.T;
  const int nq = a.nH * a.nW;
  const int q = (blockIdx.x / BT) * THREADS + threadIdx.x;
  if (q >= nq) return;
  const long long HW = (long long)a.H * a.W;
  const int qh = q / a.nW;
  const float h_ref = (float)(qh * a.stride0);
  const float w_ref = (float)((q - qh * a.nW) * a.stride0);
  const float* g_out = a.g_out + (long long)p * a.S * 2 * nq + q;
  float gh = 0.f, gw = 0.f;  // the gradient of the position after slot si
  for (int hi = a.S; hi >= 1; hi -= SEG) {
    const int lo = max(1, hi - SEG + 1);
    // the forward walk to slot hi; the positions slots lo..hi sample at
    float ph[SEG], pw[SEG];
    float h = h_ref, w = w_ref;
    for (int si = 1; si <= hi; ++si) {
      const Slot s = slot_of(ti, si, a.T, a.wt);
      if (s.restart) {
        h = h_ref;
        w = w_ref;
      }
#pragma unroll
      for (int j = 0; j < SEG; ++j) {
        if (j == si - lo) {
          ph[j] = h;
          pw[j] = w;
        }
      }
      if (si == hi) break;
      const float* f = (s.fwd ? a.fflow : a.bflow) + ((long long)b * a.T + s.pick) * 2 * HW;
      float dW, dH;
      sample(f, f + HW, h, w, a.H, a.W, &dW, &dH);
      h = __fadd_rn(h, dH);
      w = __fadd_rn(w, dW);
    }
    // the slots backward
    for (int si = hi; si >= lo; --si) {
      const Slot s = slot_of(ti, si, a.T, a.wt);
#pragma unroll
      for (int j = 0; j < SEG; ++j) {
        if (j == si - lo) {
          h = ph[j];
          w = pw[j];
        }
      }
      const float* go = g_out + (long long)(si - 1) * 2 * nq;
      gw += __ldg(go);
      gh += __ldg(go + nq);
      const long long at = ((long long)b * a.T + s.pick) * 2 * HW;
      const float* f = (s.fwd ? a.fflow : a.bflow) + at;
      float* g_f = s.fwd ? a.g_fflow : a.g_bflow;
      const float h0 = floorf(h), w0 = floorf(w);
      const float fh = __fsub_rn(h, h0), fw = __fsub_rn(w, w0);
      const int c[2] = {corner(w0, 0, a.W), corner(w0, 1, a.W)};
      const float ww[2] = {weight(0, fw), weight(1, fw)};
      float g_wh[2] = {0.f, 0.f}, g_ww[2] = {0.f, 0.f};
#pragma unroll
      for (int di = 0; di < 2; ++di) {
        const int row = corner(h0, di, a.H) * a.W;
        const float wh = weight(di, fh);
#pragma unroll
        for (int dj = 0; dj < 2; ++dj) {
          const int o = row + c[dj];
          const float wgt = wh * ww[dj];
          const float g_wgt = gw * __ldg(f + o) + gh * __ldg(f + HW + o);
          g_wh[di] += g_wgt * ww[dj];
          g_ww[dj] += g_wgt * wh;
          if (g_f) {
            atomicAdd(g_f + at + o, wgt * gw);
            atomicAdd(g_f + at + HW + o, wgt * gh);
          }
        }
      }
      const float g_fh = g_wh[0] * weight_grad(0, fh) + g_wh[1] * weight_grad(1, fh);
      const float g_fw = g_ww[0] * weight_grad(0, fw) + g_ww[1] * weight_grad(1, fw);
      // the position before the step: through the identity and the
      // weights, unless the slot restarted the walk from the query
      gh = s.restart ? 0.f : gh + g_fh;
      gw = s.restart ? 0.f : gw + g_fw;
    }
  }
}

// blocks of a launch over the (b, ti) planes, chunks of `per` queries each;
// 0 where the grid would not fit
long long walk_blocks(const WalkArgs& a, int per) {
  const long long nq = (long long)a.nH * a.nW;
  const long long blocks = (nq + per - 1) / per * a.B * a.T;
  if ((long long)a.H * a.W > 0x7fffffffLL || nq > 0x7fffffffLL ||
      blocks > 0x7fffffffLL)
    return 0;
  return blocks;
}

}  // namespace

// F1. Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue where a frame or the grid outgrows 32 bits.
extern "C" int stnls_search_flow_fwd(const float* fflow, const float* bflow,
                                     float* out, int B, int T, int H, int W,
                                     int nH, int nW, int wt, int stride0,
                                     void* stream_ptr) {
  const int S = min(2 * wt + 1, T) - 1;
  WalkArgs a{fflow, bflow, nullptr, out, nullptr, nullptr,
             B, T, H, W, nH, nW, wt, stride0, S};
  if (B <= 0 || T <= 0 || S <= 0 || nH <= 0 || nW <= 0) return 0;
  const long long blocks = walk_blocks(a, THREADS * QPT);
  if (blocks == 0) return (int)cudaErrorInvalidValue;
  search_flow_fwd_kernel<<<(unsigned)blocks, THREADS, 0,
                           static_cast<cudaStream_t>(stream_ptr)>>>(a);
  return (int)cudaGetLastError();
}

// F2: adds the flows' gradients into g_fflow and g_bflow (zeroed by the
// caller; either may be null). Returns as F1.
extern "C" int stnls_search_flow_bwd(const float* fflow, const float* bflow,
                                     const float* g_out, float* g_fflow,
                                     float* g_bflow, int B, int T, int H,
                                     int W, int nH, int nW, int wt,
                                     int stride0, void* stream_ptr) {
  const int S = min(2 * wt + 1, T) - 1;
  WalkArgs a{fflow, bflow, g_out, nullptr, g_fflow, g_bflow,
             B, T, H, W, nH, nW, wt, stride0, S};
  if (B <= 0 || T <= 0 || S <= 0 || nH <= 0 || nW <= 0) return 0;
  const long long blocks = walk_blocks(a, THREADS);
  if (blocks == 0) return (int)cudaErrorInvalidValue;
  search_flow_bwd_kernel<<<(unsigned)blocks, THREADS, 0,
                           static_cast<cudaStream_t>(stream_ptr)>>>(a);
  return (int)cudaGetLastError();
}
