// A variant of B7 (stnls_tpu_torch/csrc/agg_scatter_add_fwd.cu), timed by
// stnls_tpu_torch/b7_b10_variants.py and never built into the port: the
// shipped design with the form of its adds chosen at the launch (cl = 1:
// the shipped channels-last accumulator; cl = 0: VW scalar atomics into
// the planar output, coalesced across neighbouring queries where their
// destinations are aligned).

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

struct ScatterArgs {
  const float* vid;      // [B,HD,T,F,H,W]
  const float* weights;  // [B,HD,T,nH,nW,K]
  const float* flows;    // [B,HD,T,nH,nW,K,3] as (dt, dh, dw)
  float* out;            // [B,HD,T,F,outH,outW], or [B,HD,T,outH,outW,Fp] (CL); zeroed
  int K, T, F, Fp, H, W, nH, nW, outH, outW;
  int ps, strideIn, strideOut, pt, dilation, reflect, use_adj, ng, np;
};

// VW: channels a lane; PS: ps compiled in (0: at run time); CL: the
// output is a channels-last accumulator
template <int VW, int PS, bool CL>
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
  const long long o_frame = HWo * (CL ? a.Fp : a.F);
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
          add_form<VW, CL>(o, pix, HWo, a.Fp, c0, nc, w, x);
        });
      }
    }
  }
}

template <int VW, int PS>
void launch_ps(const ScatterArgs& a, bool cl, dim3 grid, cudaStream_t s) {
  if (cl) agg_scatter_add_fwd_kernel<VW, PS, true><<<grid, kThreads, 0, s>>>(a);
  else agg_scatter_add_fwd_kernel<VW, PS, false><<<grid, kThreads, 0, s>>>(a);
}

template <int VW>
void launch(const ScatterArgs& a, bool cl, bool compiled, dim3 grid, cudaStream_t s) {
  if (compiled && a.ps == 3) launch_ps<VW, 3>(a, cl, grid, s);
  else launch_ps<VW, 0>(a, cl, grid, s);
}

}  // namespace

// vw (1, 2 or 4), ng (a power of two up to 32) and np: the lanes'
// channels (cuda_lib.channel_layout), Fp = vw * ng * np. cl: `out` is a
// channels-last accumulator [B,HD,T,outH,outW,Fp], else planar; either is
// zeroed by the caller. compiled: take the body with ps compiled in where
// there is one (ps = 3). Returns cudaGetLastError() after the launch (0
// on success).
extern "C" int stnls_agg_scatter_add_fwd(
    const float* vid, const float* weights, const float* flows, float* out,
    int B, int HD, int K, int T, int F, int H, int W, int nH, int nW,
    int outH, int outW, int ps, int strideIn, int strideOut, int pt,
    int dilation, int reflect, int use_adj, int vw, int ng, int np, int cl,
    int compiled, void* stream_ptr) {
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
  if (vw == 4) launch<4>(a, cl, compiled, grid, s);
  else if (vw == 2) launch<2>(a, cl, compiled, grid, s);
  else launch<1>(a, cl, compiled, grid, s);
  return (int)cudaGetLastError();
}
