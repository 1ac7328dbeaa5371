"""The data-parallel layout of a training run (counterpart of
medicalsemseg_tpu/parallel/mesh.py).

JAX shards the global batch over a one-axis device mesh under jit; the port
runs one process per GPU, so the mesh becomes a process group. Training
uses dp ranks, dp being the largest divisor of the global batch b =
``n_images_per_batch * t_n_patches_per_image`` that is at most the world
size (or ``mesh_shape[0]``); with dp < world the ranks from dp on sit out
the steps and every rank validates. :func:`replicated` is a broadcast of
rank 0's weights, :func:`shard_batch` takes this rank's b / dp rows.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist

from medicalsemseg_tpu_torch.parallel.dist import get_rank, get_world_size


@dataclass
class DataParallel:
    """This rank's place in the training layout."""

    dp: int                 # training ranks
    rank: int               # this process's rank in the world
    world: int              # processes in the world
    group: Optional[object] = None  # the training ranks' process group

    @property
    def trains(self) -> bool:
        return self.rank < self.dp


def data_parallel_size(batch: int, world: int,
                       mesh_shape: Optional[Sequence[int]] = None) -> int:
    """dp: ``mesh_shape`` (k,) gives k; otherwise the largest divisor of
    ``batch`` that is at most ``world``. A mesh of more than one axis raises,
    as the JAX package's does for a shape that its axis names do not match."""
    if mesh_shape is not None:
        shape = ((mesh_shape,) if isinstance(mesh_shape, int)
                 else tuple(mesh_shape))
        if len(shape) != 1:
            raise ValueError("mesh_shape and axis_names must have equal "
                             f"length: the port's mesh is ('data',), got "
                             f"{shape}")
        dp = int(shape[0])
        if not 1 <= dp <= world or batch % dp:
            raise ValueError(f"mesh_shape {shape}: dp must divide the batch "
                             f"{batch} and be at most the world {world}")
        return dp
    return max(d for d in range(1, world + 1) if batch % d == 0)


def create_mesh(batch: int, mesh_shape: Optional[Sequence[int]] = None
                ) -> DataParallel:
    """The layout of the current world for a global batch of ``batch``
    crops. Every rank must call it (``new_group`` is collective)."""
    rank, world = get_rank(), get_world_size()
    dp = data_parallel_size(batch, world, mesh_shape)
    group = None
    if world > 1:
        group = (dist.group.WORLD if dp == world
                 else dist.new_group(ranks=list(range(dp))))
    if dp < world:
        print(f"batch {batch} not divisible by {world} ranks; "
              f"using {dp}-way data parallelism")
    return DataParallel(dp=dp, rank=rank, world=world, group=group)


def replicated(module: torch.nn.Module, src: int = 0) -> torch.nn.Module:
    """Broadcast rank ``src``'s parameters and buffers to every rank."""
    if get_world_size() > 1:
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                dist.broadcast(t.data, src)
    return module


def shard_batch(batch: Dict[str, torch.Tensor], rank: int, dp: int
                ) -> Dict[str, torch.Tensor]:
    """This rank's b / dp leading rows of a global batch."""
    out = {}
    for k, v in batch.items():
        n = v.shape[0] // dp
        if n * dp != v.shape[0]:
            raise ValueError(f"batch {k}: {v.shape[0]} rows over {dp} ranks")
        out[k] = v[rank * n:(rank + 1) * n]
    return out
