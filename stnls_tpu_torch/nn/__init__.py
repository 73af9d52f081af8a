"""NN-ops layer: flow composition, anchoring, top-K and the composite
attention module."""

from stnls_tpu_torch.nn.flow import (
    search_flow, accumulate_flow, run_accumulate_flow,
    extract_search_from_accumulated, index_grid,
)
from stnls_tpu_torch.nn.anchor_self import (
    anchor_self, anchor_self_time, anchor_self_refine, anchor_self_paired,
)
from stnls_tpu_torch.nn.topk import (
    topk, topk_each, standard_topk, anchored_topk,
)
from stnls_tpu_torch.nn.non_local_inds import non_local_inds
from stnls_tpu_torch.nn.non_local_attn import (
    NonLocalAttention, ConvQKV, LayerNorm2D,
)
from stnls_tpu_torch.nn.non_local_attn_stack import NonLocalAttentionStack
