"""Named profiler ranges at the boundaries of the package's layers.

`span(name)` is `torch.profiler.record_function(name)` and nothing else.
Under a running torch.profiler the range is recorded with its start, its
end and the range that encloses it, by the same session that records the
device's activity: its times are on the device trace's clock, a kernel
can be credited to the span whose host code launched it, and a backward
op to the span of the forward op that made its autograd node (the
profiler writes the node's sequence number on both). With no profiler
running it costs the call into the profiler; it keeps no state and
writes nothing.

Names are stnls.<layer>.<stage>:

  stnls.attn.qkv ... .proj   NonLocalAttention's five stages (qkv, search,
                             normz, agg, proj), with or without attn_timer
  stnls.search               NonLocalSearch.forward, any route
  stnls.search.flow          search_flow inside it (nn/flow)
  stnls.search.select        the selecting kernel (B1) and its input copies
  stnls.search.geometry      the lazy route's geometry: its positions,
                             frames and offsets with the anchored slot 0
                             (ops/nls_geometry_cuda: the kernel G1 on the
                             card, ops/nls_k.cells_geometry on the CPU)
  stnls.search.volume        the volume or lattice route: the volume and the
                             self_action and top-K menu (ops/anchor,
                             ops/topk)
  stnls.search.refine        RefineSearch.forward
  stnls.search.dists.bwd     the search's backward (B2, its copies and
                             accumulators)
  stnls.agg.gather           the gather stack (B3 and its channels-last copy)
  stnls.agg.gather.bwd       its backward (B4)
  stnls.agg.scatter          NonLocalScatter.forward
  stnls.agg.pool             PooledPatchSum (agg/pool.pooled_patch_sum: B9
                             and its input copies)
  stnls.dinat.na             DiNAT's attention core (models/dinat
                             NeighborhoodAttention: the heads' split, the
                             search, the bias, the softmax, the pool, the
                             merged heads)
"""

import torch


def span(name):
    """A profiler range named `name`, as a context manager."""
    return torch.profiler.record_function(name)
