"""Model export/import in the reference's own format
(``rtfs_net_tpu/models/serialization.py``; reference
``src/models/TDAVNet/base_av_model.py``: ``serialize()`` packs
``{model_name, model_args, state_dict, infos.software_versions}`` and
``from_pretrain`` rebuilds the model by name).

The port's parameter names are the reference's, so one ``torch.save`` of
that dict is a ``best_model.pth`` the reference loads. ``load_model``
reads such a blob, the reference's own ``best_model.pth`` and a Lightning
checkpoint of the reference's training system (see its docstring).
"""
from __future__ import annotations

import os
import pickle
from typing import Any, Dict, Optional, Tuple

import torch

from . import build_model
from . import get as get_model

_PREFIX = "audio_model."


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


def _read_checkpoint(path: str):
    """``torch.load`` of ``path`` on the CPU, with ``weights_only=True``. A
    file that holds more than tensors and plain containers (a Lightning
    checkpoint's ``hyper_parameters`` and optimizer state may) is read
    again with ``weights_only=False``, which runs the code the file's
    pickle names: the callers pass only a path their user named."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        return torch.load(path, map_location="cpu", weights_only=False)


def load_model(path: str, device="cuda", conf: Optional[Dict[str, Any]] = None
               ) -> Tuple[torch.nn.Module, Dict[str, Any]]:
    """-> (model in eval mode on ``device``, its package: ``model_name``,
    the constructor ``model_args`` used, the ``state_dict`` loaded).

    ``path`` holds one of:

    * a blob this package wrote (``model_args`` are the constructor
      arguments of ``model_name``, a name of the model registry);
    * a reference ``best_model.pth``, whose ``model_args`` is the
      reference's reflective ``get_config()`` dict (sections keyed
      ``encoder``, ``audio_bottleneck``, ...), not constructor arguments;
    * a Lightning checkpoint, whose ``state_dict`` keys carry the
      ``audio_model.`` prefix (only those keys are taken), or a bare state
      dict.

    As ``scripts/import_checkpoint.py:53-72`` rules, an AVNet's constructor
    arguments are the file's ``model_args`` when they hold
    ``enc_dec_params``, else ``conf["audionet"]`` (``conf`` is a whole
    config or its ``audionet`` section). The state dict loads strictly.
    """
    blob = _read_checkpoint(path)
    nested = isinstance(blob, dict) and "state_dict" in blob
    state_dict = blob["state_dict"] if nested else blob
    model_name = blob.get("model_name", "AVNet") if nested else "AVNet"
    model_args = blob.get("model_args") if nested else None
    get_model(model_name)  # an unregistered name fails before anything is built
    if any(k.startswith(_PREFIX) for k in state_dict):
        state_dict = {k[len(_PREFIX):]: v for k, v in state_dict.items()
                      if k.startswith(_PREFIX)}
    is_avnet = model_name.lower() == "avnet"
    if is_avnet and not (isinstance(model_args, dict) and "enc_dec_params" in model_args):
        if conf is None:
            raise ValueError(
                f"{path} does not hold AVNet's constructor arguments (a reference "
                "blob's model_args is its get_config() dict; a Lightning checkpoint "
                "has none): pass the experiment's config, whose audionet section "
                "holds them")
        model_args = conf.get("audionet", conf)
    model = build_model(model_args or {}, device=device, model_name=model_name)
    model.load_state_dict(state_dict)
    return model, {"model_name": model_name, "model_args": model_args,
                   "state_dict": state_dict}


def from_pretrain(path: str, device="cuda", conf: Optional[Dict[str, Any]] = None
                  ) -> torch.nn.Module:
    return load_model(path, device, conf)[0]
