"""Model construction: ``build_model(conf)`` -> an AVNet (or another
model of the registry, reference ``src/models/__init__.py:15-42``) and
``build_video_model(conf)`` -> its lip-reading video model, each in eval
mode on the requested device (``cuda`` unless the caller passes
``device="cpu"``)."""
from __future__ import annotations

import inspect
from typing import Optional

import torch
from torch import nn

from . import videomodels
from .avnet import AVNet
from .layers import accepted_kwargs


_REGISTRY = {"avnet": AVNet}


def register_model(custom_model):
    """Add a model class to the registry under its (case-insensitive) name."""
    name = getattr(custom_model, "__name__", None) or type(custom_model).__name__
    if name.lower() in _REGISTRY:
        raise ValueError(f"Model {name} already registered")
    _REGISTRY[name.lower()] = custom_model
    return custom_model


def get(identifier):
    if callable(identifier):
        return identifier
    cls = _REGISTRY.get(identifier.lower()) if isinstance(identifier, str) else None
    if cls is None:
        raise ValueError(f"Could not interpret model identifier: {identifier}")
    return cls


def resolve_device(device) -> torch.device:
    """``torch.device(device)``; a CUDA device without a usable card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return device


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-draw every randomly initialised parameter from ``generator``, in
    module order (norms and gates keep their constant initialisation)."""
    for m in model.modules():
        reset = getattr(m, "reset_parameters", None)
        if reset is not None and "generator" in inspect.signature(reset).parameters:
            reset(generator=generator)
    return model


def build_model(conf: dict, device="cuda", generator: Optional[torch.Generator] = None,
                model_name="AVNet") -> nn.Module:
    """The registry's ``model_name`` (default AVNet) from a YAML config (the
    whole file or its ``audionet`` section), dropping keys its constructor
    does not take, weights drawn from ``generator`` (default: seed 0), in
    eval mode."""
    device = resolve_device(device)
    cls = get(model_name)
    conf = conf.get("audionet", conf)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model = init_weights(cls(**accepted_kwargs(cls, conf)), generator)
    return model.to(device).eval()


def build_video_model(conf: dict, device="cuda",
                      generator: Optional[torch.Generator] = None) -> nn.Module:
    """The video model of a YAML config (the whole file or its ``videonet``
    section), weights drawn from ``generator`` (default: seed 0), frozen
    and in eval mode. The config's ``pretrain`` path is not read: a
    published backbone loads through ``utils.convert.load_video_backbone``."""
    device = resolve_device(device)
    conf = conf.get("videonet", conf)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    cls = videomodels.get(conf["model_name"])
    model = init_weights(cls(**accepted_kwargs(cls, conf)), generator)
    return model.to(device).eval()
