"""stnls_tpu_torch: the PyTorch + CUDA port of stnls_tpu for NVIDIA Hopper.

Flow-guided space-time attention built from a differentiable non-local
search, softmax normalisation and non-local aggregation. The JAX package
stnls_tpu is the reference; this package mirrors its module names and
public layouts. Its hand-written CUDA kernels (csrc/) are built with nvcc
at first use; on CPU tensors every kernel wrapper runs its plain PyTorch
version. This package never imports JAX.
"""

__version__ = "0.1.0"

from stnls_tpu_torch import utils
from stnls_tpu_torch import ops
from stnls_tpu_torch import search
from stnls_tpu_torch import normz
from stnls_tpu_torch import agg
from stnls_tpu_torch import nn
