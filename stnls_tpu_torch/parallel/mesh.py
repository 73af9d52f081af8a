"""Mesh construction helpers (PyTorch port of stnls_tpu/parallel/mesh.py).

A JAX Mesh over a device list becomes a torch.distributed DeviceMesh over
the ranks of the default process group, which the caller initialises
(`torch.distributed.init_process_group`: NCCL on the card, gloo on the
CPU). A PartitionSpec becomes a tuple of DTensor placements, one per mesh
dimension.
"""

from typing import NamedTuple

import numpy as np
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard


def make_mesh(axes=None, device_type="cuda"):
    """Build a DeviceMesh over the process group's ranks.

    axes: dict axis_name -> size (sizes must multiply to the world size),
    e.g. {"data": 2, "time": 4}; the ranks fill the mesh in row-major
    order, as JAX's device list does. Default: all ranks on one "data"
    axis. device_type: "cuda" (one card a rank, NCCL) or "cpu" (gloo)."""
    n = dist.get_world_size()
    if axes is None:
        axes = {"data": n}
    sizes = tuple(int(v) for v in axes.values())
    assert int(np.prod(sizes)) == n, \
        f"mesh sizes {axes} must multiply to {n} ranks"
    return init_device_mesh(device_type, sizes,
                            mesh_dim_names=tuple(axes.keys()))


def data_head_specs(mesh, data_axis="data", head_axis=None):
    """Placements for the standard video layout [B,HD,T,F,H,W]: batch
    sharded over `data_axis`, heads over `head_axis` (if any), replicated
    over every other mesh dimension. Returns (vid, flow, out) placements,
    all the same, as JAX's (vid_spec, flow_spec, out_spec)."""
    dims = {data_axis: 0, head_axis: 1}
    spec = tuple(Shard(dims[name]) if name in dims else Replicate()
                 for name in mesh.mesh_dim_names)
    return spec, spec, spec


class NamedSharding(NamedTuple):
    """A mesh and the placements of one tensor on it, the counterpart of
    jax.sharding.NamedSharding; `torch.distributed.tensor.
    distribute_tensor(x, *sharding)` lays a tensor out by it."""
    mesh: DeviceMesh
    placements: tuple


def named(mesh, spec):
    return NamedSharding(mesh, tuple(spec))
