"""Separator registry (reference ``src/models/separators/__init__.py``)."""
from __future__ import annotations

from torch import nn

from .dpt import DPTNet, DPTNetBlock
from .frcnn import FRCNN, FRCNNBlock
from .tdanet import TDANet, TDANetBlock


class IdentitySeparator(nn.Module):
    """Stand-in for a disabled branch (``separators.get(None)``)."""

    def get_block(self, i: int) -> nn.Module:
        return self

    def forward(self, x):
        return x


_REGISTRY = {"TDANet": TDANet, "FRCNN": FRCNN, "DPTNet": DPTNet}


def get(identifier):
    if identifier is None:
        return IdentitySeparator
    if callable(identifier):
        return identifier
    cls = _REGISTRY.get(identifier) if isinstance(identifier, str) else None
    if cls is None:
        raise ValueError(f"Could not interpret separator identifier: {identifier}")
    return cls
