"""Layer registry (reference ``src/models/layers/__init__.py``), limited to
the layer types the port has so far. ``build`` drops config keys the
layer's constructor does not take, as the reference's ``**kwargs`` do."""
from __future__ import annotations

import inspect

from .conv_blocks import ConvNormAct, ConvActNorm, FeedForwardNetwork, make_norm
from .rnn_blocks import DualPathRNN
from .attention_blocks import (
    GlobalAttention,
    MultiHeadSelfAttention,
    MultiHeadSelfAttention2D,
    positional_encoding,
)
from .fusion_cells import (
    ATTNFusionCell,
    ConvGRUFusionCell,
    ConvLSTMFusionCell,
    InjectionMultiSum,
)

_REGISTRY = {
    cls.__name__: cls
    for cls in (ConvNormAct, ConvActNorm, FeedForwardNetwork, DualPathRNN,
                MultiHeadSelfAttention, MultiHeadSelfAttention2D, GlobalAttention,
                InjectionMultiSum, ConvLSTMFusionCell, ConvGRUFusionCell, ATTNFusionCell)
}


def get(identifier):
    if callable(identifier):
        return identifier
    cls = _REGISTRY.get(identifier) if isinstance(identifier, str) else None
    if cls is None:
        raise ValueError(f"Could not interpret layer identifier: {identifier}")
    return cls


def accepted_kwargs(cls, kwargs: dict) -> dict:
    params = inspect.signature(cls.__init__).parameters
    return {k: v for k, v in kwargs.items() if k in params and k != "self"}


def build(cls_or_name, **kwargs):
    cls = get(cls_or_name)
    return cls(**accepted_kwargs(cls, kwargs))
