"""Model construction: ``build_model(conf)`` -> an AVNet and
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


def build_model(conf: dict, device="cuda", generator: Optional[torch.Generator] = None) -> AVNet:
    """AVNet from a YAML config (the whole file or its ``audionet`` section),
    weights drawn from ``generator`` (default: seed 0), in eval mode."""
    device = resolve_device(device)
    conf = conf.get("audionet", conf)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model = init_weights(AVNet(**accepted_kwargs(AVNet, conf)), generator)
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
