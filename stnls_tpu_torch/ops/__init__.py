"""Compute cores shared by the public API layers: plain PyTorch engines
and the wrappers of the hand-written CUDA kernels (nls_cuda,
nls_vol_cuda, agg_cuda, agg_sp_cuda)."""

from stnls_tpu_torch.ops import geometry
from stnls_tpu_torch.ops import nls
from stnls_tpu_torch.ops import nls_k
from stnls_tpu_torch.ops import agg
from stnls_tpu_torch.ops import anchor
from stnls_tpu_torch.ops import topk
from stnls_tpu_torch.ops import nls_cuda
from stnls_tpu_torch.ops import nls_vol_cuda
from stnls_tpu_torch.ops import agg_cuda
from stnls_tpu_torch.ops import agg_sp_cuda
