"""Aggregation layer: weighted non-local patch stacking."""

from stnls_tpu_torch.agg.gather import NonLocalGather, non_local_gather
from stnls_tpu_torch.agg.api import init, extract_config
