// B7: NonLocalScatterAdd forward, for Hopper.
//
// Replaces the Pallas TPU kernel stnls_tpu/ops/agg_pallas_sp.py:
// _make_scatter_add_fwd_kernel (entry nl_scatter_add_pallas). Plain
// version: stnls_tpu_torch/ops/agg_sp_cuda.py::nl_scatter_add_plain (the
// port of stnls_tpu/ops/agg.py::nl_scatter_add).
//
// What it computes, for every query q = (t, qh, qw) of the strideIn grid,
// slot k, frame step pk and patch tap p = (pi, pj) at d = dilation * (p +
// patch_offset):
//   out[nt, c, reflect(nl_h + d_h), reflect(nl_w + d_w)]
//       += w[q,k] * vid[t + pk, c, qh*strideIn + d_h, qw*strideIn + d_w]
// with the rounded offsets' centre (nl_t, nl_h, nl_w) taken on the
// strideOut grid of the (outH, outW) output and reflected once, nt =
// nl_t + pk (reflected when reflect_bounds). Read-side taps outside the
// frame, a read frame t + pk >= T, destinations outside the output and
// -1e8 fills are dropped. The output is not normalised.
//
// What bounds it on the H100: bytes. At the agg example's 128^2 it reads
// 12.6 MB of weights and offsets and a 3.1 MB video and writes a 3.1 MB
// output, against ~1e8 flops; but the output is written by float atomics,
// read-modify-write in L2, one per (live slot, tap, channel) at least.
//
// What the design does about it: one thread per (query, vector of VW
// channels), a query's ng lanes side by side in a warp (B2's layout,
// cuda_lib.channel_layout), in blocks of one (b, hd, frame, query row)
// with 32-bit index arithmetic. For each frame step a lane reads its
// channels of the video at the query's taps once (in registers for ps =
// 3, else through L1 at each use: agg_patch.cuh::LocalPatch), then the
// lanes walk the query's K slots together: a zero weight is skipped by
// all of them at once, so one live slot in eight (the agg example's
// softmax(-10 d)) leaves no lane idle, where the first design (a thread
// per (query, slot)) left seven of eight. For each kept tap a lane adds
// w * its channels with one float2/float4 atomic into a channels-last
// accumulator, which the wrapper then moves to the planar output. There
// is no cheap inverse of the non-local map, so the scatter stays a
// scatter, in no fixed order (compare at 1e-4). Measured and not shipped
// (PERF.md): VW scalar atomics into the planar output, 2-5x slower where
// the destinations scatter and within 6% where they are aligned, which
// the host cannot tell apart; launch bounds, other block sizes, two
// channels a lane.

#include "agg_patch.cuh"

namespace {

constexpr int kThreads = 128;

struct ScatterArgs {
  const float* vid;      // [B,HD,T,F,H,W]
  const float* weights;  // [B,HD,T,nH,nW,K]
  const float* flows;    // [B,HD,T,nH,nW,K,3] as (dt, dh, dw)
  float* out;            // [B,HD,T,outH,outW,Fp] channels-last, zeroed by the caller
  int K, T, F, Fp, H, W, nH, nW, outH, outW;
  int ps, strideIn, strideOut, pt, dilation, reflect, use_adj, ng, np;
};

// VW: channels a lane; PS: ps compiled in (0: at run time)
template <int VW, int PS>
__global__ void __launch_bounds__(kThreads) agg_scatter_add_fwd_kernel(ScatterArgs a) {
  const int ng = a.ng, g = threadIdx.x & (ng - 1);
  const int qw = blockIdx.x * (kThreads / ng) + threadIdx.x / ng;
  if (qw >= a.nW) return;
  const int qh = blockIdx.y, bt = blockIdx.z;   // bt: (b, hd, t)
  const int t = bt % a.T, bhd = bt / a.T;
  const int ps = PS > 0 ? PS : a.ps, dil = a.dilation;
  const int po = a.use_adj ? 0 : -(ps / 2);
  const long long HWi = (long long)a.H * a.W, HWo = (long long)a.outH * a.outW;
  const long long q = ((long long)bt * a.nH + qh) * a.nW + qw;
  const float* wq = a.weights + q * a.K;
  const float* fq = a.flows + q * a.K * 3;
  const long long o_frame = HWo * a.Fp;
  float* ob = a.out + (long long)bhd * a.T * o_frame;

  for (int pass = 0; pass < a.np; ++pass) {
    const int c0 = (pass * ng + g) * VW, nc = min(VW, a.F - c0);
    if (nc <= 0) break;                     // this lane's channels are padding
    for (int pk = 0; pk < a.pt && t + pk < a.T; ++pk) {
      const LocalPatch<PS, VW> vp(a.vid + (((long long)bhd * a.T + t + pk) * a.F + c0) * HWi,
                                  HWi, a.H, a.W, qh * a.strideIn + dil * po,
                                  qw * a.strideIn + dil * po, dil, nc);
      for (int k = 0; k < a.K; ++k) {
        const float w = __ldg(wq + k);
        int nl_t, nl_h, nl_w;
        if (w == 0.f || !nl_centre(fq + 3 * k, t, qh, qw, a.strideOut, a.T, a.outH, a.outW,
                                   &nl_t, &nl_h, &nl_w))
          continue;
        int nt = nl_t + pk;
        if (a.reflect) nt = reflect1(nt, a.T);
        if (!inb(nt, a.T)) continue;
        float* o = ob + nt * o_frame;
        walk_taps<PS>(ps, dil, po, nl_h, nl_w, a.outH, a.outW, a.reflect,
                      [&](int pi, int pj, int pix) {
          if (!vp.in(pi, pj)) return;
          float x[VW];
          vp.get(x, pi, pj);
          add_channels<VW>(o, pix, a.Fp, c0, w, x);
        });
      }
    }
  }
}

template <int VW>
void launch(const ScatterArgs& a, bool compiled, dim3 grid, cudaStream_t s) {
  if (compiled && a.ps == 3) agg_scatter_add_fwd_kernel<VW, 3><<<grid, kThreads, 0, s>>>(a);
  else agg_scatter_add_fwd_kernel<VW, 0><<<grid, kThreads, 0, s>>>(a);
}

}  // namespace

// vw (1, 2 or 4), ng (a power of two up to 32) and np: the lanes'
// channels (cuda_lib.channel_layout); `out` is a channels-last
// accumulator [B,HD,T,outH,outW,Fp], Fp = vw * ng * np, zeroed by the
// caller. compiled: take the body with ps compiled in where there is one
// (ps = 3). Returns cudaGetLastError() after the launch (0 on success).
extern "C" int stnls_agg_scatter_add_fwd(
    const float* vid, const float* weights, const float* flows, float* out,
    int B, int HD, int K, int T, int F, int H, int W, int nH, int nW,
    int outH, int outW, int ps, int strideIn, int strideOut, int pt,
    int dilation, int reflect, int use_adj, int vw, int ng, int np, int compiled,
    void* stream_ptr) {
  if (ng < 1 || ng > 32 || (ng & (ng - 1)) || (vw != 1 && vw != 2 && vw != 4) ||
      vw * ng * np < F)
    return (int)cudaErrorInvalidValue;
  if ((long long)B * HD * T * nH * nW == 0 || K == 0) return 0;
  if (nH > 65535 || (long long)B * HD * T > 65535) return (int)cudaErrorInvalidConfiguration;
  ScatterArgs a{vid, weights, flows, out, K, T, F, vw * ng * np, H, W, nH, nW, outH, outW,
                ps, strideIn, strideOut, pt, dilation, reflect, use_adj, ng, np};
  const int per_block = kThreads / ng;
  const dim3 grid((unsigned)((nW + per_block - 1) / per_block), (unsigned)nH,
                  (unsigned)(B * HD * T));
  const cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  if (vw == 4) launch<4>(a, compiled, grid, s);
  else if (vw == 2) launch<2>(a, compiled, grid, s);
  else launch<1>(a, compiled, grid, s);
  return (int)cudaGetLastError();
}
