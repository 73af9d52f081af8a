// A variant of B10 (stnls_tpu_torch/csrc/agg_pool_bwd.cu), timed by
// stnls_tpu_torch/b7_b10_variants.py and never built into the port: with
// ps = 3 compiled in, a block first stages the cotangent rows of its
// queries, every channel, in shared memory with coalesced loads along x,
// and each lane takes its block of the cotangent from there into
// registers (the shipped kernel reads it from global memory, each lane
// its ps x ps pixels, ps apart across neighbouring queries).

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
  extern __shared__ float tile[];           // [F][PS][cols]
  const int ng = a.ng, g = threadIdx.x & (ng - 1);
  const int q0 = blockIdx.x * (kThreads / ng), cols = (kThreads / ng) * PS;
  const int qw = q0 + threadIdx.x / ng;
  const int qh = blockIdx.y, bt = blockIdx.z;   // bt: (b, hd, t)
  const int ps = PS > 0 ? PS : a.ps, outH = ps * a.nH, outW = ps * a.nW;
  const int po = a.use_adj ? 0 : -(ps / 2);
  const int base = (ps - 1) / 2 + 1 + po;   // psHalf + patch_offset
  const long long HW = (long long)a.H * a.W, HWo = (long long)outH * outW;
  if constexpr (PS > 0) {
    const float* gsrc = a.g_out + (long long)bt * a.F * HWo;
    const int x0 = q0 * PS + base;
    for (int i = threadIdx.x; i < a.F * PS * cols; i += kThreads) {
      const int col = i % cols, r = i / cols, pi = r % PS, c = r / PS;
      const int y = qh * PS + base + pi, x = x0 + col;
      tile[i] = y < outH && x < outW ? __ldg(gsrc + c * HWo + (long long)y * outW + x) : 0.f;
    }
    __syncthreads();
  }
  if (qw >= a.nW) return;                   // a query's lanes leave together
  const unsigned seg = query_lanes(ng);
  const int t = bt % a.T, bhd = bt / a.T;
  const long long q = ((long long)bt * a.nH + qh) * a.nW + qw;
  const float* wq = a.weights + q * a.K;
  const float* fq = a.flows + q * a.K * 3;
  float* gwq = a.g_weights + q * a.K;
  const long long frame = HW * a.Fp;
  const float* vb = a.vid + (long long)bhd * a.T * frame;
  float* gb = a.g_vid + (long long)bhd * a.T * frame;

  for (int pass = 0; pass < a.np; ++pass) {
    const int c0 = (pass * ng + g) * VW, nc = min(VW, a.F - c0);
    LocalPatch<PS, VW> gp(a.g_out + ((long long)bt * a.F + c0) * HWo, HWo, outH, outW,
                          qh * ps + base, qw * ps + base, 1, PS > 0 ? 0 : nc);
    if constexpr (PS > 0) {
#pragma unroll
      for (int pi = 0; pi < PS; ++pi)
#pragma unroll
        for (int pj = 0; pj < PS; ++pj)
#pragma unroll
          for (int c = 0; c < VW; ++c)
            gp.v[pi * PS + pj][c] = c < nc ? tile[((c0 + c) * PS + pi) * cols +
                                                   (qw - q0) * PS + pj] : 0.f;
    }
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
  const size_t smem = (size_t)a.F * 3 * (kThreads / a.ng) * 3 * sizeof(float);
  if (compiled && a.ps == 3) agg_pool_bwd_kernel<VW, 3><<<grid, kThreads, smem, s>>>(a);
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
  if ((long long)B * HD * T * nH * nW == 0 || K == 0) return 0;
  if (nH > 65535 || (long long)B * HD * T > 65535) return (int)cudaErrorInvalidConfiguration;
  PoolBwdArgs a{vid, weights, flows, g_out, g_vid, g_weights, K, T, F, vw * ng * np, H, W,
                nH, nW, ps, stride0, pt, dilation, reflect, use_adj, need_vid, ng, np};
  const int per_block = kThreads / ng;
  const dim3 grid((unsigned)((nW + per_block - 1) / per_block), (unsigned)nH,
                  (unsigned)(B * HD * T));
  const cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
  if (vw == 4) launch<4>(a, compiled, grid, s);
  else if (vw == 2) launch<2>(a, compiled, grid, s);
  else launch<1>(a, compiled, grid, s);
  return (int)cudaGetLastError();
}
