"""Data parallelism (``rtfs_net_tpu/parallel/``'s counterpart): one
process per device, joined by ``torch.distributed`` (NCCL on the cards,
gloo on the CPU), the model in ``DistributedDataParallel`` with
``SyncBatchNorm``, each step the one-device step on the global batch."""
from .distributed import initialize, launch, local_device, process_info, shutdown, \
    wait_for_devices
from .mesh import Mesh, make_mesh, make_parallel_train_step, make_parallel_val_step, \
    mesh_size, shard_batch
from .sync_batchnorm import SyncBatchNorm, convert_sync_batchnorm

__all__ = ["initialize", "launch", "local_device", "process_info", "shutdown",
           "wait_for_devices", "Mesh", "make_mesh", "make_parallel_train_step",
           "make_parallel_val_step", "mesh_size", "shard_batch", "SyncBatchNorm",
           "convert_sync_batchnorm"]
