"""The JAX side's tools outside its package (``scripts/``), on the port:
each a ``python -m rtfs_net_tpu_torch.scripts.<name>`` command that runs
on the card unless ``--device cpu`` is given.

This package imports no torch at the top: the loader bench's spawned
workers import its main module again.
"""
import os
import sys

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "configs")


def config_path(name):
    """The path of a shipped config (``configs/<name>.yaml``)."""
    return os.path.join(CONFIGS, f"{name}.yaml")


def load_config(name):
    import yaml

    with open(config_path(name)) as f:
        return yaml.safe_load(f)


def device_or_none(tool, device):
    """``torch.device(device)``; None, after saying why on stderr, where it
    names a card and there is none (the caller then exits non-zero and
    prints no result, as ``rtfs_net_tpu_torch.bench`` does)."""
    import torch

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print(f"{tool}: no CUDA device; pass --device cpu to run on the CPU", file=sys.stderr)
        return None
    return device


def synchronize(device):
    """Wait for the card's queue where ``device`` is a card."""
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_name(device):
    """The card's name (``torch.cuda.get_device_name``), or ``cpu``."""
    import torch

    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
