"""Model export/import in the reference's own format
(``rtfs_net_tpu/models/serialization.py``; reference
``src/models/TDAVNet/base_av_model.py``: ``serialize()`` packs
``{model_name, model_args, state_dict, infos.software_versions}`` and
``from_pretrain`` rebuilds the model by name).

The port's parameter names are the reference's, so one ``torch.save`` of
that dict is a ``best_model.pth`` the reference loads, and a reference
``best_model.pth`` loads here. The blob holds tensors and plain
containers only and is read with ``torch.load(..., weights_only=True)``.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Tuple

import torch

from . import build_model


def serialize(model_name: str, model_args: Dict[str, Any], state_dict) -> Dict[str, Any]:
    return {
        "model_name": model_name,
        "model_args": model_args,
        "state_dict": {k: v.detach().cpu() for k, v in state_dict.items()},
        "infos": {"software_versions": {"torch_version": str(torch.__version__)}},
    }


def save_model(path: str, model_name: str, model_args: Dict[str, Any], state_dict):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(serialize(model_name, model_args, state_dict), path)


def load_model(path: str, device="cuda") -> Tuple[torch.nn.Module, Dict[str, Any]]:
    """-> (model in eval mode on ``device``, the blob). The model is built
    from the embedded ``model_args`` and loaded strictly."""
    package = torch.load(path, map_location="cpu", weights_only=True)
    if package["model_name"] != "AVNet":
        raise ValueError(f"{path}: model {package['model_name']!r} is not ported")
    model = build_model(package["model_args"], device=device)
    model.load_state_dict(package["state_dict"])
    return model, package


def from_pretrain(path: str, device="cuda") -> torch.nn.Module:
    return load_model(path, device)[0]
