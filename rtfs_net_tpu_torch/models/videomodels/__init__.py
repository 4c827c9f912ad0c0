"""Video model registry (reference ``src/models/videomodels/__init__.py``:
a case-insensitive ``get``)."""
from __future__ import annotations

from .autoencoder import AE, DecoderAE, EncoderAE
from .frcnn_videomodel import AEVideoModel, FRCNNVideoModel
from .resnet import BasicBlock, ResNet
from .shufflenetv2 import STAGE_OUT_CHANNELS, ShuffleNetV2Trunk

_REGISTRY = {
    "frcnnvideomodel": FRCNNVideoModel,
    "aevideomodel": AEVideoModel,
}


def get(identifier):
    if identifier is None:
        return None
    if callable(identifier):
        return identifier
    if isinstance(identifier, str):
        cls = _REGISTRY.get(identifier.lower())
        if cls is not None:
            return cls
    raise ValueError(f"Could not interpret videomodel identifier: {identifier}")
