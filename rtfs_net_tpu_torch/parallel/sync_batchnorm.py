"""BatchNorm with statistics over every rank of a process group (the
reference trains with ``sync_batchnorm=True``; the JAX package's step on
the global batch has them for free, ``rtfs_net_tpu/parallel/mesh.py:9-13``).

``SyncBatchNorm`` is ``nn.SyncBatchNorm``'s counterpart: the parameters and
buffers of the ``BatchNorm*d`` it replaces (the same state-dict keys),
training-mode statistics in float32 from sums taken on each rank and added
over the group by differentiable all-reduces: the mean from the sum and
count, then the variance from the sum of squared deviations about that
mean, as one process computes them over the whole batch. The backward of
each all-reduce adds the gradients over the group, so every rank's
parameters get the gradient of the global batch's loss. On a group of one
rank, and outside training mode, it is the plain BatchNorm in float32 and
issues no collective (as ``nn.SyncBatchNorm`` skips the sync on one rank).
``nn.SyncBatchNorm`` itself runs only on a card (its statistics are CUDA
operators, and ``DistributedDataParallel`` refuses it in a CPU module);
this one runs the same on the CPU over gloo as on a card over NCCL.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn


class _AllReduce(torch.autograd.Function):
    """Sum over ``group``; the gradient is summed over it too."""

    @staticmethod
    def forward(ctx, tensor, group):
        ctx.group = group
        out = tensor.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class SyncBatchNorm(nn.modules.batchnorm._BatchNorm):
    def __init__(self, num_features, eps=1e-5, momentum=0.1, affine=True,
                 track_running_stats=True, process_group=None):
        super().__init__(num_features, eps, momentum, affine, track_running_stats)
        self.process_group = process_group

    def _check_input_dim(self, x):
        if x.dim() < 2:
            raise ValueError(f"expected at least 2D input (got {x.dim()}D input)")

    def forward(self, x):
        self._check_input_dim(x)
        group = self.process_group or dist.group.WORLD
        if not (self.training and dist.is_initialized() and dist.get_world_size(group) > 1):
            # one rank's statistics are the batch's: plain BatchNorm, in float32
            return super().forward(x.float()).to(x.dtype)
        xf = x.float()
        weight = None if self.weight is None else self.weight.float()
        bias = None if self.bias is None else self.bias.float()
        dims = [0] + list(range(2, x.dim()))
        shape = [1, -1] + [1] * (x.dim() - 2)
        local = torch.cat([xf.sum(dims), xf.new_full((1,), x.numel() // x.shape[1])])
        total = _AllReduce.apply(local, group)
        count = total[-1]
        mean = total[:-1] / count
        centred = xf - mean.view(shape)
        var = _AllReduce.apply(centred.square().sum(dims), group) / count
        y = centred * torch.rsqrt(var + self.eps).view(shape)
        if weight is not None:
            y = y * weight.view(shape) + bias.view(shape)
        if self.track_running_stats:
            with torch.no_grad():
                self.num_batches_tracked.add_(1)
                momentum = (1.0 / float(self.num_batches_tracked) if self.momentum is None
                            else self.momentum)
                unbiased = var * (count / (count - 1).clamp(min=1))
                self.running_mean.lerp_(mean, momentum)
                self.running_var.lerp_(unbiased, momentum)
        return y.to(x.dtype)


def convert_sync_batchnorm(module: nn.Module, process_group=None) -> nn.Module:
    """Replace every BatchNorm of ``module`` (in place, and returned) by a
    ``SyncBatchNorm`` over ``process_group`` (None: the default group) that
    holds the same parameter and buffer tensors, so an optimizer built on
    the parameters keeps updating them and the state dict's keys do not
    change."""
    for name, child in module.named_children():
        if isinstance(child, nn.modules.batchnorm._BatchNorm) and not isinstance(
                child, SyncBatchNorm):
            sync = SyncBatchNorm(child.num_features, child.eps, child.momentum, child.affine,
                                 child.track_running_stats, process_group)
            if child.affine:
                sync.weight, sync.bias = child.weight, child.bias
            if child.track_running_stats:
                sync.running_mean, sync.running_var = child.running_mean, child.running_var
                sync.num_batches_tracked = child.num_batches_tracked
            sync.train(child.training)
            setattr(module, name, sync)
        else:
            convert_sync_batchnorm(child, process_group)
    return module
