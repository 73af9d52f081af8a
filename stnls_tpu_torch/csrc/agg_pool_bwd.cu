// B10: PooledPatchSum backward, for Hopper.
//
// Replaces the Pallas TPU kernel stnls_tpu/ops/agg_pallas_sp.py:
// _make_pool_bwd_kernel (the backward of the custom_vjp _pool_op). Plain
// version: stnls_tpu_torch/ops/agg_sp_cuda.py::_pool_bwd_plain, the VJP of
// the plain pool (stnls_tpu_torch/ops/agg.py::nl_pool).
//
// What it computes, from the output cotangent g [B,HD,T,F,ps*nH,ps*nW] and
// the forward's map (agg_pool_fwd.cu) from a (query, slot, frame step,
// tap) to its read pixel r and its output pixel o (ps odd):
//   g_vid[r, c] += w[q,k] * g[o, c] / (1 + 1e-10),
//   g_w[q,k]     = sum over (pk, tap, c) of vid[r, c] * g[o, c] / (1 + 1e-10),
// over the taps the forward kept (its output pixel on the grid, its read
// pixel in the frame). 1 + 1e-10 is 1.0f in float32: the cotangent is
// taken as it is. Where the forward zeroed a weight (below 1e-8, negative
// ones too, or a -1e8 fill) both are 0. The offsets are rounded: they get
// no gradient (the wrapper returns zeros).
//
// What bounds it on the H100: bytes. At the agg example's 128^2 it reads
// the 28 MB cotangent, 12.6 MB of weights and offsets and the video, and
// writes the 3.1 MB video gradient and the weight gradient.
//
// What the design does about it: one thread per (query, vector of VW
// channels), a query's ng lanes side by side in a warp (B2's layout,
// cuda_lib.channel_layout), in blocks of one (b, hd, frame, query row)
// with 32-bit index arithmetic. Each lane first reads its channels of the
// query's private ps x ps block of the cotangent, once (in registers for
// ps = 3, else through L1 at each use: agg_patch.cuh::LocalPatch); the
// first design read the block again for each live slot. Then the lanes
// walk the query's K slots together: a slot whose weight the forward
// zeroed is skipped by all of them at once, so one live slot in eight
// (the agg example's softmax(-10 d)) leaves no lane idle. For each kept
// tap a lane adds w * its cotangent into the video gradient with one
// float2/float4 atomic into a channels-last accumulator, and sums vid[r]
// * g[o] over its channels, read with one vector load from a
// channels-last copy of the video (both made and moved back by the
// wrapper); the query's lanes then combine their sums with shuffles in a
// fixed order and one writes g_w[q,k]: deterministic. The video gradient
// depends on the order of the atomics (compare at 1e-4 * max|g|).
// Measured and not shipped (PERF.md): planar scalar atomics and planar
// video reads, 1.7-4x slower where the destinations scatter, up to 6%
// faster where they are aligned, which the host cannot tell apart; the
// cotangent rows staged in shared memory; launch bounds, other block
// sizes, two channels a lane.

#include "agg_patch.cuh"

namespace {

constexpr int kThreads = 128;

struct PoolBwdArgs {
  const float* vid;      // [B,HD,T,H,W,Fp] channels-last
  const float* weights;  // [B,HD,T,nH,nW,K]
  const float* flows;    // [B,HD,T,nH,nW,K,3] as (dt, dh, dw)
  const float* g_out;    // [B,HD,T,F,ps*nH,ps*nW]
  float* g_vid;          // [B,HD,T,H,W,Fp] channels-last, zeroed by the caller
  float* g_weights;      // [B,HD,T,nH,nW,K]
  int K, T, F, Fp, H, W, nH, nW;
  int ps, stride0, pt, dilation, reflect, use_adj, need_vid, ng, np;
};

// VW: channels a lane; PS: ps compiled in (0: at run time)
template <int VW, int PS>
__global__ void __launch_bounds__(kThreads) agg_pool_bwd_kernel(PoolBwdArgs a) {
  const int ng = a.ng, g = threadIdx.x & (ng - 1);
  const int qw = blockIdx.x * (kThreads / ng) + threadIdx.x / ng;
  if (qw >= a.nW) return;                   // a query's lanes leave together
  const unsigned seg = query_lanes(ng);
  const int qh = blockIdx.y, bt = blockIdx.z;   // bt: (b, hd, t)
  const int t = bt % a.T, bhd = bt / a.T;
  const int ps = PS > 0 ? PS : a.ps, outH = ps * a.nH, outW = ps * a.nW;
  const int po = a.use_adj ? 0 : -(ps / 2);
  const int base = (ps - 1) / 2 + 1 + po;   // psHalf + patch_offset
  const long long HW = (long long)a.H * a.W, HWo = (long long)outH * outW;
  const long long q = ((long long)bt * a.nH + qh) * a.nW + qw;
  const float* wq = a.weights + q * a.K;
  const float* fq = a.flows + q * a.K * 3;
  float* gwq = a.g_weights + q * a.K;
  const long long frame = HW * a.Fp;
  const float* vb = a.vid + (long long)bhd * a.T * frame;
  float* gb = a.g_vid + (long long)bhd * a.T * frame;

  for (int pass = 0; pass < a.np; ++pass) {
    const int c0 = (pass * ng + g) * VW, nc = min(VW, a.F - c0);
    const LocalPatch<PS, VW> gp(a.g_out + ((long long)bt * a.F + c0) * HWo, HWo, outH, outW,
                                qh * ps + base, qw * ps + base, 1, nc);
    for (int k = 0; k < a.K; ++k) {
      const float w = __ldg(wq + k);
      int nl_t, nl_h, nl_w;
      if (w < 1e-8f ||
          !nl_centre(fq + 3 * k, t, qh, qw, a.stride0, a.T, a.H, a.W, &nl_t, &nl_h, &nl_w)) {
        if (pass == 0 && g == 0) gwq[k] = 0.f;
        continue;
      }
      float gw = 0.f;
      for (int pk = 0; pk < a.pt; ++pk) {
        const int nt = reflect1(nl_t + pk, a.T);
        if (!inb(nt, a.T)) continue;
        const float* v = vb + nt * frame;
        float* gv = gb + nt * frame;
        walk_taps<PS>(ps, a.dilation, po, nl_h, nl_w, a.H, a.W, a.reflect,
                      [&](int pi, int pj, int pix) {
          if (!gp.in(pi, pj)) return;
          float x[VW], y[VW];
          gp.get(x, pi, pj);
          load_channels<VW, true>(y, v + (long long)pix * a.Fp + c0, 1, VW);
#pragma unroll
          for (int c = 0; c < VW; ++c) gw += y[c] * x[c];
          if (a.need_vid && nc > 0) add_channels<VW>(gv, pix, a.Fp, c0, w, x);
        });
      }
      // the query's lanes hold the same (q, k): sum their channels
      for (int m = 1; m < ng; m <<= 1) gw += __shfl_xor_sync(seg, gw, m);
      if (g == 0) gwq[k] = pass == 0 ? gw : gwq[k] + gw;
    }
  }
}

template <int VW>
void launch(const PoolBwdArgs& a, bool compiled, dim3 grid, cudaStream_t s) {
  if (compiled && a.ps == 3) agg_pool_bwd_kernel<VW, 3><<<grid, kThreads, 0, s>>>(a);
  else agg_pool_bwd_kernel<VW, 0><<<grid, kThreads, 0, s>>>(a);
}

}  // namespace

// ps must be odd; g_vid is written only when need_vid. vw (1, 2 or 4), ng
// (a power of two up to 32) and np: the lanes' channels
// (cuda_lib.channel_layout); `vid` and `g_vid` are channels-last with Fp
// = vw * ng * np channels (padding 0 in `vid`). compiled: take the body
// with ps compiled in where there is one (ps = 3). Returns
// cudaGetLastError() after the launch.
extern "C" int stnls_agg_pool_bwd(
    const float* vid, const float* weights, const float* flows,
    const float* g_out, float* g_vid, float* g_weights,
    int B, int HD, int K, int T, int F, int H, int W, int nH, int nW, int ps,
    int stride0, int pt, int dilation, int reflect, int use_adj,
    int need_vid, int vw, int ng, int np, int compiled, void* stream_ptr) {
  if (ps % 2 == 0 || ng < 1 || ng > 32 || (ng & (ng - 1)) ||
      (vw != 1 && vw != 2 && vw != 4) || vw * ng * np < F)
    return (int)cudaErrorInvalidValue;
  const long long n_w = (long long)B * HD * T * nH * nW * K;
  if (n_w == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  if (F == 0) {                   // no channel: g_w is 0 (g_vid is empty)
    cudaMemsetAsync(g_weights, 0, n_w * sizeof(float), s);
    return (int)cudaGetLastError();
  }
  if (nH > 65535 || (long long)B * HD * T > 65535) return (int)cudaErrorInvalidConfiguration;
  PoolBwdArgs a{vid, weights, flows, g_out, g_vid, g_weights, K, T, F, vw * ng * np, H, W,
                nH, nW, ps, stride0, pt, dilation, reflect, use_adj, need_vid, ng, np};
  const int per_block = kThreads / ng;
  const dim3 grid((unsigned)((nW + per_block - 1) / per_block), (unsigned)nH,
                  (unsigned)(B * HD * T));
  if (vw == 4) launch<4>(a, compiled, grid, s);
  else if (vw == 2) launch<2>(a, compiled, grid, s);
  else launch<1>(a, compiled, grid, s);
  return (int)cudaGetLastError();
}
