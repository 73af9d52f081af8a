"""NN-ops layer: flow composition and the composite attention module."""

from stnls_tpu_torch.nn.flow import search_flow, accumulate_flow
from stnls_tpu_torch.nn.non_local_attn import (
    NonLocalAttention, ConvQKV, LayerNorm2D,
)
