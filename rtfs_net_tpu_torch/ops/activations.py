"""Activation registry (reference ``src/models/layers/activations.py``):
a YAML name resolves to a module class, ``None`` to Identity. The classes
carry the JAX package's constants (``rtfs_net_tpu/ops/activations.py``):
GELU is the exact erf form and LeakyReLU's slope is 0.01, as torch's
defaults are."""
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


Identity = nn.Identity
ReLU = nn.ReLU
Sigmoid = nn.Sigmoid
Tanh = nn.Tanh
SiLU = nn.SiLU
ELU = nn.ELU


class GELU(nn.GELU):
    """``jax.nn.gelu(approximate=False)``: the exact erf form."""

    def __init__(self):
        super().__init__(approximate="none")


class LeakyReLU(nn.LeakyReLU):
    def __init__(self, negative_slope: float = 0.01):
        super().__init__(negative_slope)


class Softplus(nn.Module):
    """``jax.nn.softplus``: log(1 + e^x) everywhere (torch's ``nn.Softplus``
    returns x itself above 20)."""

    def forward(self, x):
        return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


_REGISTRY = {
    "identity": Identity,
    "relu": ReLU,
    "prelu": PReLU,
    "sigmoid": Sigmoid,
    "tanh": Tanh,
    "gelu": GELU,
    "silu": SiLU,
    "leakyrelu": LeakyReLU,
    "elu": ELU,
    "softplus": Softplus,
}


def get(identifier):
    if identifier is None:
        return Identity
    if callable(identifier):
        return identifier
    if isinstance(identifier, str):
        cls = _REGISTRY.get(identifier.lower())
        if cls is not None:
            return cls
    raise ValueError(f"Could not interpret activation identifier: {identifier}")
