"""NN-ops layer: flow composition, anchoring, top-K and the composite
attention module."""

from stnls_tpu_torch.nn.flow import search_flow, accumulate_flow
from stnls_tpu_torch.nn.anchor_self import anchor_self, anchor_self_time
from stnls_tpu_torch.nn.topk import (
    topk, topk_each, standard_topk, anchored_topk,
)
from stnls_tpu_torch.nn.non_local_attn import (
    NonLocalAttention, ConvQKV, LayerNorm2D,
)
