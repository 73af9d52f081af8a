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
// read bilinearly (float) or at one pixel (int), as B1 reads them (the
// shared code of nls_common.cuh); cells outside the frame hold the init
// value (+inf for l2, -inf for prod). Output dists
// [B,HD,T,W_t,ws,ws,nH,nW]: the volume that the self_action and top-K menu
// of search/non_local_search._self_action_topk then reduces. In a temporal
// chunk (time sharding, nls_pallas_volume's query_t0 / T_global mode) the
// T query frames are one chunk of the sequence and the videos hold Tv =
// T + 2*halo frames (nls_common.cuh, chunk_window_frame).
//
// What bounds it on the H100: the same load-issue-bound patch reads as B1
// (at the slice config 125 cells x 9 taps x 8 channels x 4 corners per
// query, L1/L2-resident videos), plus the 82 MB volume it writes (the
// bytes bound is 0.025 ms; the arithmetic bound 0.220 ms).
//
// What the design does about it: one thread per (query, slot, window
// row wi), looping over the ws cells of the row, so the slice launches
// 4.1M threads; neighbouring threads on neighbouring qw, so each store
// of one cell into [..,ws,ws,nH,nW] is coalesced and the corner reads of
// one tap fall on neighbouring addresses. ps and F are run-time
// arguments, the query patch read at each use through the read-only cache;
// (3, 8) and (3, 16) also have a body with the query patch in registers,
// reused across the row's cells (nls_common.cuh), faster there (PERF.md).
// No shared memory, no atomics; deterministic.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "nls_common.cuh"

namespace {

struct VolArgs {
  const float* vid0;   // [B,HD,Tv,F,H,W]
  const float* vid1;   // [B,HD,Tv,F,H,W]
  const float* ctr_h;  // [B,HD,T,W_t,nH,nW] reflected centres (integers for int)
  const float* ctr_w;
  float* dists;        // [B,HD,T,W_t,ws,ws,nH,nW]
  int B, HD, T, F, H, W, nH, nW, W_t;
  int Tv, t0, Tg, halo;  // video frames and the chunk (nls_common.cuh)
  int ws, wt, ps, stride0, dilation;
  float stride1;       // float path; the int path passes max(1, int(stride1))
  float s1_half;       // stride1 * ((ws-1)/2), rounded once on the host
  int l2, full_ws, use_adj, is_int;
};

// PS, FC > 0: ps and F compiled in; (0, 0): taken from the arguments.
template <int PS, int FC>
__global__ void __launch_bounds__(128) nls_vol_fwd_kernel(VolArgs a) {
  const long long n = (long long)a.B * a.HD * a.T * a.W_t * a.ws * a.nH * a.nW;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int qw = (int)(i % a.nW);
  long long r = i / a.nW;
  const int qh = (int)(r % a.nH);
  r /= a.nH;
  const int wi = (int)(r % a.ws);
  r /= a.ws;
  const int st = (int)(r % a.W_t);
  const long long bhdt = r / a.W_t;         // (b * HD + hd) * T + t
  const int t = (int)(bhdt % a.T);
  const long long bhd = bhdt / a.T;

  const int H = a.H, W = a.W, ws = a.ws;
  const long long FHW = (long long)(FC > 0 ? FC : a.F) * H * W;
  const long long plane = (long long)a.nH * a.nW;
  const int ref_h = (qh * a.stride0) % H;
  const int ref_w = (qw * a.stride0) % W;

  typename QueryOf<PS, FC>::type qp;
  qp.load(a, a.vid0 + (bhd * a.Tv + a.halo + t) * FHW, ref_h, ref_w);

  const long long c = (bhdt * a.W_t + st) * plane + (long long)qh * a.nW + qw;
  const float ch = a.ctr_h[c], cw = a.ctr_w[c];
  float oh, ow;
  window_offsets(a, ch, cw, &oh, &ow);
  const int tj = chunk_window_frame(t, st, a.wt, a.t0, a.Tg, a.halo);
  const float* v1 = a.vid1 + (bhd * a.Tv + tj) * FHW;

  const float init = a.l2 ? CUDART_INF_F : -CUDART_INF_F;
  const float ph0 = lattice(ch, oh, a.stride1, wi);
  const bool vh = inb_f(ph0, H);
  float* out = a.dists + ((bhdt * a.W_t + st) * ws + wi) * ws * plane
               + (long long)qh * a.nW + qw;
  for (int wj = 0; wj < ws; ++wj) {
    const float pw0 = lattice(cw, ow, a.stride1, wj);
    float d = init;
    if (vh && inb_f(pw0, W)) d = patch_dist(a, v1, qp, ph0, pw0);
    out[wj * plane] = d;
  }
}

template <int PS, int FC>
cudaError_t launch(const VolArgs& a, cudaStream_t stream) {
  const long long n = (long long)a.B * a.HD * a.T * a.W_t * a.ws * a.nH * a.nW;
  if (n == 0) return cudaSuccess;
  const int threads = 128;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  nls_vol_fwd_kernel<PS, FC><<<blocks, threads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// The (ps, F a head) pairs with ps and F compiled in, the one list of
// them. Every other pair, and every pair when `compiled` is 0, runs the
// run-time body <0, 0>.
#define STNLS_VOL_COMPILED(X) X(3, 8) X(3, 16)

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int stnls_nls_vol_fwd(
    const float* vid0, const float* vid1, const float* ctr_h,
    const float* ctr_w, float* dists, int B, int HD, int T, int F, int H,
    int W, int nH, int nW, int W_t, int Tv, int t0, int Tg, int halo, int ws,
    int wt, int ps, int stride0, int dilation, float stride1, float s1_half,
    int l2, int full_ws, int use_adj, int is_int, int compiled,
    void* stream_ptr) {
  VolArgs a{vid0, vid1, ctr_h, ctr_w, dists, B, HD, T, F, H, W, nH, nW, W_t,
            Tv, t0, Tg, halo, ws, wt, ps, stride0, dilation, stride1, s1_half,
            l2, full_ws, use_adj, is_int};
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
#define STNLS_LAUNCH(P, FC) \
  if (compiled && ps == P && F == FC) return (int)launch<P, FC>(a, stream);
  STNLS_VOL_COMPILED(STNLS_LAUNCH)
#undef STNLS_LAUNCH
  return (int)launch<0, 0>(a, stream);
}

// 1 when (ps, F) has a body with ps and F compiled in, else 0.
extern "C" int stnls_nls_vol_compiled(int ps, int F) {
#define STNLS_HAS(P, FC) if (ps == P && F == FC) return 1;
  STNLS_VOL_COMPILED(STNLS_HAS)
#undef STNLS_HAS
  return 0;
}
