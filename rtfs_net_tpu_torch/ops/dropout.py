"""Dropout with explicit randomness.

Masks are drawn from the ``torch.Generator`` made active by
``use_generator`` (``System.train_step`` activates the one it is given),
or from PyTorch's global generator when none is active. The generator
must lie on the activations' device. Semantics follow ``flax.linen.Dropout``:
keep each element with probability 1-p and scale kept ones by 1/(1-p).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch

_active = threading.local()


@contextlib.contextmanager
def use_generator(generator: Optional[torch.Generator]):
    """Draw dropout masks in this thread from ``generator`` inside the block."""
    previous = active_generator()
    _active.generator = generator
    try:
        yield generator
    finally:
        _active.generator = previous


def active_generator() -> Optional[torch.Generator]:
    return getattr(_active, "generator", None)


def keep_mask(shape, keep: float, device) -> torch.Tensor:
    """Boolean mask, True with probability ``keep``."""
    return torch.rand(shape, generator=active_generator(), device=device) < keep


def dropout(x: torch.Tensor, p: float, training: bool) -> torch.Tensor:
    if not training or p == 0.0:
        return x
    keep = 1.0 - p
    return torch.where(keep_mask(x.shape, keep, x.device), x / keep, torch.zeros_like(x))
