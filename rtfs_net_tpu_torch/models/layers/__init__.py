"""Layer registry (reference ``src/models/layers/__init__.py``). ``build``
drops config keys the layer's constructor does not take, as the
reference's ``**kwargs`` do."""
from __future__ import annotations

import inspect

from .conv_blocks import (
    ConvNormAct,
    ConvActNorm,
    DepthwiseSeparableConvolution,
    FeedForwardNetwork,
    ConvolutionalRNN,
    apply_norm,
    make_norm,
)
from .rnn_blocks import (
    RNNProjection,
    DualPathRNN,
    ConvLSTMCell,
    BiLSTM2D,
    GlobalAttentionRNN,
    GlobalGALR,
)
from .mixer_blocks import MLP, Permutator
from .attention_blocks import (
    MultiHeadSelfAttention,
    MultiHeadSelfAttention2D,
    GlobalAttention,
    GlobalAttention2D,
    CBAMBlock,
    ShuffleAttention,
    CoTAttention,
    TorchMultiheadAttention,
    positional_encoding,
)
from .fusion_cells import (
    ATTNFusionCell,
    ConvGRUFusionCell,
    ConvLSTMFusionCell,
    InjectionMultiSum,
)
from ...ops.activations import Identity

_REGISTRY = {
    cls.__name__: cls
    for cls in (ConvNormAct, ConvActNorm, DepthwiseSeparableConvolution, FeedForwardNetwork,
                ConvolutionalRNN, RNNProjection, DualPathRNN, BiLSTM2D, MLP, Permutator,
                GlobalAttentionRNN, GlobalGALR, MultiHeadSelfAttention,
                MultiHeadSelfAttention2D, GlobalAttention, GlobalAttention2D, CBAMBlock,
                ShuffleAttention, CoTAttention, InjectionMultiSum, ConvLSTMFusionCell,
                ConvGRUFusionCell, ATTNFusionCell)
}


def get(identifier):
    if identifier is None:
        return Identity
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


def get_ffn(name: str):
    """The FFN of an attention block by name (reference ``conv_layers.get``)."""
    return {"FeedForwardNetwork": FeedForwardNetwork, "ConvolutionalRNN": ConvolutionalRNN}[name]
