"""Dropout with explicit randomness.

Masks are drawn from the ``torch.Generator`` made active by
``use_generator`` (``System.train_step`` activates the one it is given),
or from PyTorch's global generator when none is active. The generator
must lie on the activations' device. Semantics follow ``flax.linen.Dropout``:
keep each element with probability 1-p and scale kept ones by 1/(1-p).

Under data parallelism each process holds a shard of the batch. With a
``shard`` active, a mask is drawn for the whole batch and cut to the
process's rows, so every process draws the masks one process running the
whole batch would, and the generators stay in step.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional, Tuple

import torch

_active = threading.local()


@contextlib.contextmanager
def use_generator(generator: Optional[torch.Generator], shard: Tuple[int, int] = (0, 1)):
    """Draw dropout masks in this thread from ``generator`` inside the block.
    ``shard`` = (index, count): this process holds rows ``index*B ..
    (index+1)*B`` of a batch of ``count*B`` rows."""
    previous = (active_generator(), active_shard())
    _active.generator, _active.shard = generator, shard
    try:
        yield generator
    finally:
        _active.generator, _active.shard = previous


def active_generator() -> Optional[torch.Generator]:
    return getattr(_active, "generator", None)


def active_shard() -> Tuple[int, int]:
    return getattr(_active, "shard", (0, 1))


def keep_mask(shape, keep: float, device, batch_dim: int = 0) -> torch.Tensor:
    """Boolean mask, True with probability ``keep``; ``batch_dim`` is the
    dimension of ``shape`` that holds the batch."""
    index, count = active_shard()
    if count == 1:
        return torch.rand(shape, generator=active_generator(), device=device) < keep
    rows = shape[batch_dim]
    whole = list(shape)
    whole[batch_dim] = rows * count
    draw = torch.rand(whole, generator=active_generator(), device=device)
    return draw.narrow(batch_dim, index * rows, rows) < keep


def dropout(x: torch.Tensor, p: float, training: bool, batch_dim: int = 0) -> torch.Tensor:
    if not training or p == 0.0:
        return x
    keep = 1.0 - p
    return torch.where(keep_mask(x.shape, keep, x.device, batch_dim), x / keep,
                       torch.zeros_like(x))


class Dropout(torch.nn.Module):
    """``dropout`` as a module (``flax.linen.Dropout``): in training mode
    each element is kept with probability 1-p, the mask drawn from the
    active generator; the identity in eval mode."""

    def __init__(self, p: float = 0.0):
        super().__init__()
        self.p = p

    def forward(self, x):
        return dropout(x, self.p, self.training)
