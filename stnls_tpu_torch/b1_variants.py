"""Time B1 (stnls_tpu_torch/csrc/nls_topk_fwd.cu) against variants of
its source on one NVIDIA GPU, in turns (shipped, variants, variants in
reverse, shipped), each variant's outputs held bitwise equal to the
shipped kernel's.

Run from the repository root: python3 -m stnls_tpu_torch.b1_variants

Variants:
  register_list: the bodies with (ps, F) compiled in keep the ranked list
    in registers (16 entries, the bucket that K = 10 anchored takes: a
    fully unrolled insertion with `i < n` as a predicate, the worst entry
    in a register as the threshold) in place of the shared-memory list.
Cases: the slice's (3, 8) on 128^2 and the 1080p alignment search's
(1, 2) on config 5's frames (benchmarks/matrix.py, stnls_tpu_torch/
matrix_steps.py) and on their 270x480 crop. Prints the card's name and
power limit, each build's ptxas stack frame of B1's compiled bodies, and
the CUDA-event medians. Exits non-zero without a CUDA device. Imports
nothing of JAX.
"""

import re
import sys
from pathlib import Path

import numpy as np

from stnls_tpu_torch import variant_tools as vt

REG_LIST = """// The ranked list of up to NS entries in registers: every index is a
// compile-time constant after unrolling, and `i < n` is a predicate.
template <int NS>
struct RegList {
  float ld[NS];
  int lp[NS];
  float wd;   // the worst kept entry, ld[n - 1]: the reject threshold
  int wp;
  int n;
  float init;

  __device__ __forceinline__ void start(int nkeep, float init_d) {
    n = nkeep;
    init = init_d;
#pragma unroll
    for (int i = 0; i < NS; ++i) { ld[i] = init_d; lp[i] = INT_MAX; }
    wd = init_d;
    wp = INT_MAX;
  }
  __device__ __forceinline__ void insert(bool l2, float d, int pos) {
    if (n == 0 || !better(l2, d, pos, wd, wp)) return;
    // carry the new entry down the list: it swaps with each entry it
    // ranks above, so the entries below move down by one
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      if (i < n) {
        const bool swap = better(l2, d, pos, ld[i], lp[i]);
        const float td = ld[i];
        const int tp = lp[i];
        ld[i] = swap ? d : td;
        lp[i] = swap ? pos : tp;
        d = swap ? td : d;
        pos = swap ? tp : pos;
        if (i == n - 1) { wd = ld[i]; wp = lp[i]; }
      }
    }
  }
  // drops the entry of position id pos, if kept; the last becomes empty
  __device__ __forceinline__ void remove(int pos) {
    bool found = false;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      if (i < n) {
        found = found || lp[i] == pos;
        const int j = i + 1 < NS ? i + 1 : i;
        if (found) {
          ld[i] = i + 1 < n ? ld[j] : init;
          lp[i] = i + 1 < n ? lp[j] : INT_MAX;
        }
        if (i == n - 1) { wd = ld[i]; wp = lp[i]; }
      }
    }
  }
  __device__ __forceinline__ void write(float* od, int* oc, int count, int self_idx) const {
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      if (i < count) {
        od[i] = ld[i];
        oc[i] = (lp[i] == self_idx) ? 0 : lp[i];
      }
    }
  }
};

"""

VARIANTS = {
    "register_list": [
        ("// PS, FC > 0: ps and F compiled in; (0, 0): taken from the arguments.",
         REG_LIST + "// PS, FC > 0: ps and F compiled in; (0, 0): taken from the arguments."),
        ("  RankList list;\n  list.bind(",
         "  typename std::conditional<(PS > 0), RegList<16>, RankList>::type list;\n"
         "  if constexpr (PS == 0) list.bind("),
        ("#include <limits.h>\n", "#include <limits.h>\n\n#include <type_traits>\n"),
    ],
}


def frames(log):
    """{(ps, F): 'N bytes stack frame, ...'} of B1's compiled bodies."""
    out, func = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            func = m.group(1)
        elif func and "stack frame" in line:
            b = re.search(r"nls_topk_kernelILi(\d+)ELi(\d+)E", func)
            if b and b.groups() != ("0", "0"):
                out[f"({b.group(1)}, {b.group(2)})"] = line.strip()
    return out


def main():
    root = Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        sys.exit("b1_variants: no CUDA device; it times a GPU only")
    import chip_smoke as cs
    from stnls_tpu_torch import matrix_steps as ms
    from stnls_tpu_torch.attn_step import cuda_ms
    from stnls_tpu_torch.ops import cuda_lib, nls_cuda
    print(vt.card(), flush=True)
    shipped = cuda_lib.load()
    print("shipped:", frames(shipped.log), flush=True)
    out_dir = cuda_lib.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)

    libs = {"shipped": shipped}
    for name, subs in VARIANTS.items():
        path, log = vt.build(cuda_lib, cuda_lib.CSRC / "nls_topk_fwd.cu",
                             out_dir, f"b1_{name}", subs)
        print(f"{name}:", frames(log), flush=True)
        libs[name] = vt.Variant(shipped, path, "stnls_nls_topk_fwd")

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(cs.SEED)
    v0, v1, fl = cs.make_inputs(torch, rng, dev, B=1, HD=2, T=5, F=8, H=128,
                                W=128, wt=2)
    cases = {"(3, 8) slice 128^2": (v0, v1, fl, dict(
        ws=5, wt=2, ps=3, stride0=1, stride1=0.5, k=10, anchor=True))}
    cfg = ms.config("align1080p_fwd")
    full = ms.make_inputs("align1080p_fwd", cs.SEED, device=dev)
    kw = dict(ws=cfg["ws"], wt=cfg["wt"], ps=1, stride0=1, stride1=1,
              k=cfg["K"], anchor=True)
    for label, inputs in (("(1, 2) 1080p", full),
                          ("(1, 2) 270x480 crop",
                           cs.crop_inputs(full, *cs.MATRIX_CROP))):
        v, f = cs.matrix_search_args(torch, cfg, inputs)
        cases[label] = (v, v, f, kw)
    order = list(libs) + list(libs)[::-1]
    for label, (a0, a1, f, kw) in cases.items():
        times = {name: [] for name in libs}
        ref = None
        for name in order:
            vt.swap(cuda_lib, libs[name])
            with torch.no_grad():
                d, c = nls_cuda.nls_topk(a0, a1, f, **kw)
                if ref is None:
                    ref = (d, c)
                if not (torch.equal(d, ref[0]) and torch.equal(c, ref[1])):
                    sys.exit(f"b1_variants: {name} differs at {label}")
                n = 3 if a0.shape[-1] > 1000 else 10
                times[name].append(cuda_ms(
                    lambda: nls_cuda.nls_topk(a0, a1, f, **kw), n=n, warm=1))
        vt.swap(cuda_lib, shipped)
        print(f"[B1 {label}] " + "; ".join(
            f"{name} {' / '.join(f'{t:.3f}' for t in ts)} ms"
            for name, ts in times.items()), flush=True)


if __name__ == "__main__":
    main()
