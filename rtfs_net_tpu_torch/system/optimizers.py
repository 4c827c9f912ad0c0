"""Optimizer factory (``rtfs_net_tpu/system/optimizers.py``; reference
``src/system/optimizers.py:58-108``), built on ``torch.optim``.

``adamw``, ``adam`` and ``sgd`` follow the JAX package's optax rules
(AdamW's decoupled weight decay on every parameter; SGD's weight decay
added to the gradient before momentum). The other names of the JAX
registry are not ported yet and raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Iterable

import torch

NOT_PORTED = (
    "rmsprop", "adagrad", "adamax", "radam", "adabelief", "lamb", "lars", "novograd",
    "yogi", "sm3", "adafactor", "fromage", "lion", "adadelta", "asgd", "accsgd", "sgdw",
    "qhm", "qhadam", "diffgrad", "adamod", "adabound", "pid", "ranger", "rangerva",
    "rangerqh",
)


def make_optimizer(params: Iterable[torch.nn.Parameter], optimizer: str = "adamw",
                   lr: float = 1e-3, weight_decay: float = 0.0, momentum: float = 0.0,
                   betas=(0.9, 0.999), eps: float = 1e-8,
                   **kwargs) -> torch.optim.Optimizer:
    """A ``torch.optim`` optimizer over ``params`` by name (case-insensitive,
    the config's ``optim`` section as keyword arguments)."""
    name = optimizer.lower()
    betas = tuple(betas)
    if name == "adamw":
        return torch.optim.AdamW(params, lr=lr, betas=betas, eps=eps,
                                 weight_decay=weight_decay)
    if name == "adam":
        return torch.optim.Adam(params, lr=lr, betas=betas, eps=eps)
    if name == "sgd":
        return torch.optim.SGD(params, lr=lr, momentum=momentum, weight_decay=weight_decay)
    if name in NOT_PORTED:
        raise NotImplementedError(f"optimizer {optimizer!r} is not ported yet")
    raise ValueError(f"Could not interpret optimizer identifier: {optimizer}")


def get_lr(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> torch.optim.Optimizer:
    for group in optimizer.param_groups:
        group["lr"] = lr
    return optimizer
