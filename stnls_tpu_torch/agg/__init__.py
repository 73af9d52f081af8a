"""Aggregation layer: weighted non-local patch stacking and summing."""

from stnls_tpu_torch.agg.gather import NonLocalGather, non_local_gather
from stnls_tpu_torch.agg.scatter import NonLocalScatter, non_local_scatter
from stnls_tpu_torch.agg.gather_add import NonLocalGatherAdd
from stnls_tpu_torch.agg.scatter_add import NonLocalScatterAdd
from stnls_tpu_torch.agg.pool import PooledPatchSum, WeightedPatchSum
from stnls_tpu_torch.agg.stack_conv import StackConv
from stnls_tpu_torch.agg.api import init, extract_config
