// A variant of B10 (stnls_tpu_torch/csrc/agg_pool_bwd.cu), timed by
// stnls_tpu_torch/b7_b10_variants.py and never built into the port: the
// shipped design with the form of its video gradient's adds (cl_acc) and
// of its video reads (cl_vid) chosen at the launch, each channels-last
// (the shipped form) or planar.

#include "agg_patch.cuh"

namespace {

// w * x (VW channels from c0, the nc < VW that exist) added into pixel
// `pix`: one vector atomic into a channels-last accumulator (CL, the
// shipped form) or nc scalar atomics into the planar tensor, HW apart
template <int VW, bool CL>
__device__ __forceinline__ void add_form(float* frame, int pix, long long HW, int Fp, int c0,
                                         int nc, float w, const float (&x)[VW]) {
  if constexpr (CL) {
    add_channels<VW>(frame, pix, Fp, c0, w, x);
  } else {
#pragma unroll
    for (int c = 0; c < VW; ++c)
      if (c < nc) atomicAdd(frame + (c0 + c) * HW + pix, w * x[c]);
  }
}

}  // namespace

namespace {

constexpr int kThreads = 128;

struct PoolBwdArgs {
  const float* vid;      // [B,HD,T,F,H,W], or [B,HD,T,H,W,Fp] channels-last (CLV)
  const float* weights;  // [B,HD,T,nH,nW,K]
  const float* flows;    // [B,HD,T,nH,nW,K,3] as (dt, dh, dw)
  const float* g_out;    // [B,HD,T,F,ps*nH,ps*nW]
  float* g_vid;          // [B,HD,T,F,H,W], or [B,HD,T,H,W,Fp] (CLA); zeroed by the caller
  float* g_weights;      // [B,HD,T,nH,nW,K]
  int K, T, F, Fp, H, W, nH, nW;
  int ps, stride0, pt, dilation, reflect, use_adj, need_vid, ng, np;
};

// VW: channels a lane; PS: ps compiled in (0: at run time); CLV, CLA:
// the video read and the video gradient added channels-last
template <int VW, int PS, bool CLV, bool CLA>
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
  const long long v_frame = HW * (CLV ? a.Fp : a.F), a_frame = HW * (CLA ? a.Fp : a.F);
  const float* vb = a.vid + (long long)bhd * a.T * v_frame;
  float* gb = a.g_vid + (long long)bhd * a.T * a_frame;

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
        const float* v = vb + nt * v_frame;
        float* gv = gb + nt * a_frame;
        walk_taps<PS>(ps, a.dilation, po, nl_h, nl_w, a.H, a.W, a.reflect,
                      [&](int pi, int pj, int pix) {
          if (!gp.in(pi, pj)) return;
          float x[VW], y[VW];
          gp.get(x, pi, pj);
          if constexpr (CLV)
            load_channels<VW, true>(y, v + (long long)pix * a.Fp + c0, 1, VW);
          else
            load_channels<VW, false>(y, v + c0 * HW + pix, HW, nc);
#pragma unroll
          for (int c = 0; c < VW; ++c) gw += y[c] * x[c];
          if (a.need_vid && nc > 0) add_form<VW, CLA>(gv, pix, HW, a.Fp, c0, nc, w, x);
        });
      }
      // the query's lanes hold the same (q, k): sum their channels
      for (int m = 1; m < ng; m <<= 1) gw += __shfl_xor_sync(seg, gw, m);
      if (g == 0) gwq[k] = pass == 0 ? gw : gwq[k] + gw;
    }
  }
}

template <int VW, int PS>
void launch_ps(const PoolBwdArgs& a, bool clv, bool cla, dim3 grid, cudaStream_t s) {
  if (clv && cla) agg_pool_bwd_kernel<VW, PS, true, true><<<grid, kThreads, 0, s>>>(a);
  else if (clv) agg_pool_bwd_kernel<VW, PS, true, false><<<grid, kThreads, 0, s>>>(a);
  else if (cla) agg_pool_bwd_kernel<VW, PS, false, true><<<grid, kThreads, 0, s>>>(a);
  else agg_pool_bwd_kernel<VW, PS, false, false><<<grid, kThreads, 0, s>>>(a);
}

template <int VW>
void launch(const PoolBwdArgs& a, bool clv, bool cla, bool compiled, dim3 grid,
            cudaStream_t s) {
  if (compiled && a.ps == 3) launch_ps<VW, 3>(a, clv, cla, grid, s);
  else launch_ps<VW, 0>(a, clv, cla, grid, s);
}

}  // namespace

// ps must be odd; g_vid is written only when need_vid. vw (1, 2 or 4), ng
// (a power of two up to 32) and np: the lanes' channels
// (cuda_lib.channel_layout), Fp = vw * ng * np. cl_vid: `vid` is a
// channels-last copy [B,HD,T,H,W,Fp]; cl_acc: `g_vid` is a channels-last
// accumulator [B,HD,T,H,W,Fp]; each is planar otherwise. compiled: take
// the body with ps compiled in where there is one (ps = 3). Returns
// cudaGetLastError() after the launch.
extern "C" int stnls_agg_pool_bwd(
    const float* vid, const float* weights, const float* flows,
    const float* g_out, float* g_vid, float* g_weights,
    int B, int HD, int K, int T, int F, int H, int W, int nH, int nW, int ps,
    int stride0, int pt, int dilation, int reflect, int use_adj,
    int need_vid, int vw, int ng, int np, int cl_vid, int cl_acc, int compiled,
    void* stream_ptr) {
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
  if (vw == 4) launch<4>(a, cl_vid, cl_acc, compiled, grid, s);
  else if (vw == 2) launch<2>(a, cl_vid, cl_acc, compiled, grid, s);
  else launch<1>(a, cl_vid, cl_acc, compiled, grid, s);
  return (int)cudaGetLastError();
}
