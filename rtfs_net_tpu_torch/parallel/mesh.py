"""Data parallelism over the ranks of the default process group
(``rtfs_net_tpu/parallel/mesh.py``'s counterpart; reference: Lightning's
DDP with ``sync_batchnorm=True``, ``train.py:135-146``).

The JAX step is the one-device step on the global batch: the state
replicated, the batch sharded, XLA inserting the reductions. Here each
rank holds a replica of the model and a shard of the global batch, and a
step is the one-device step on the global batch too: the model runs in
``DistributedDataParallel`` (gradients averaged over the mesh before the
clip), its BatchNorms are ``SyncBatchNorm`` (statistics of the global
batch), the reported losses are averaged over the mesh, dropout masks are
drawn for the global batch (``ops/dropout.py``) and ``online_mix`` remixes
the global batch (``System``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch.distributed as dist


@dataclass
class Mesh:
    """The first ``size`` ranks of the default process group, which a step
    spreads its batch over. ``group`` is their process group (None: every
    rank); ``index`` is this process's position among them, None outside
    the mesh (a rank that sits the steps out). ``distributed``: a process
    group exists, so the steps run through ``DistributedDataParallel`` even
    on one rank."""

    size: int
    index: Optional[int]
    group: Any = None
    distributed: bool = False

    @property
    def member(self) -> bool:
        return self.index is not None


def mesh_size(n_devices: Optional[int], world: int, batch_size: Optional[int] = None) -> int:
    """The rank count of ``make_mesh``: ``n_devices`` (default: all) up to
    ``world``, then the largest count that divides ``batch_size`` (a batch
    of 2 on 8 ranks trains on 2 rather than failing)."""
    n = min(n_devices or world, world)
    if batch_size is not None:
        while batch_size % n:
            n -= 1
    return n


def make_mesh(n_devices: Optional[int] = None, batch_size: Optional[int] = None) -> Mesh:
    """The mesh over the first ``mesh_size(...)`` ranks; without a process
    group, this one process. Every rank of the group must call it, in the
    same order (a smaller mesh builds a process group of its ranks)."""
    if not dist.is_initialized():
        return Mesh(1, 0)
    world, rank = dist.get_world_size(), dist.get_rank()
    n = mesh_size(n_devices, world, batch_size)
    group = None if n == world else dist.new_group(list(range(n)))
    return Mesh(n, rank if rank < n else None, group, True)


def shard_batch(batch, mesh: Mesh):
    """This rank's rows of a global batch tuple (None entries stay None),
    or None outside the mesh. The batch must divide by the mesh."""
    if not mesh.member:
        return None

    def rows(t):
        if t is None:
            return None
        if t.shape[0] % mesh.size:
            raise ValueError(f"batch {t.shape[0]} does not divide over {mesh.size} ranks")
        n = t.shape[0] // mesh.size
        return t[mesh.index * n:(mesh.index + 1) * n]

    return tuple(rows(t) for t in batch)


def make_parallel_train_step(system, mesh: Mesh):
    """``system.train_step`` over ``mesh``: each rank passes its shard of the
    global batch (``shard_batch``, or a loader shard) and gets the metrics
    of the global batch; a rank outside the mesh gets None and computes
    nothing."""
    if mesh.distributed and mesh.member:
        system.distribute(mesh)

    def step(batch, generator=None):
        return system.train_step(batch, generator) if mesh.member else None

    return step


def make_parallel_val_step(system, mesh: Mesh):
    """``system.val_step`` over ``mesh``: the val loss of the global batch."""
    if mesh.distributed and mesh.member:
        system.distribute(mesh)

    def step(batch):
        return system.val_step(batch) if mesh.member else None

    return step
