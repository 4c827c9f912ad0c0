"""Activation registry (reference ``src/models/layers/activations.py``):
a YAML name resolves to a module class, ``None`` to Identity."""
from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F


class PReLU(nn.Module):
    """torch ``nn.PReLU`` (init 0.25, parameter ``weight``): one slope, or
    with ``num_parameters=C`` one per channel along dim 1 of a
    (B, C, *spatial) input of any rank; the slopes are cast to the
    activation's dtype."""

    def __init__(self, num_parameters: int = 1, init: float = 0.25):
        super().__init__()
        self.weight = nn.Parameter(torch.full((num_parameters,), init))

    def forward(self, x):
        return F.prelu(x, self.weight.to(x.dtype))


_REGISTRY = {
    "identity": nn.Identity,
    "relu": nn.ReLU,
    "prelu": PReLU,
    "sigmoid": nn.Sigmoid,
    "tanh": nn.Tanh,
}


def get(identifier):
    if identifier is None:
        return nn.Identity
    if callable(identifier):
        return identifier
    if isinstance(identifier, str):
        cls = _REGISTRY.get(identifier.lower())
        if cls is not None:
            return cls
    raise ValueError(f"Could not interpret activation identifier: {identifier}")
