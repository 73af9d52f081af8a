"""Distribution layer on torch.distributed (PyTorch port of
stnls_tpu/parallel).

  * data/head sharding -- (B, HD) are embarrassingly parallel: each rank
    searches its own block (`shard_search`);
  * temporal context parallelism -- shard the frame axis T and swap a
    2*wt-frame halo around the ring of the mesh's time axis
    (`time_sharded_search`, `halo_gather`), the search kernels running in
    their temporal-chunk mode;
  * gradients of the halo frames travel back to their owners in the
    exchange's backward; a data-parallel step all-reduces its parameter
    gradients itself (stnls_tpu_torch/multichip_step.py).

Meshes are torch.distributed DeviceMeshes over the ranks of the default
process group (`make_mesh`), and every function works on each rank's
local shards.
"""

from stnls_tpu_torch.parallel.mesh import make_mesh, data_head_specs
from stnls_tpu_torch.parallel.shard import (
    shard_search, TimeShardedSearch, time_sharded_search, halo_gather,
)
