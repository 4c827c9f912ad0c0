"""Seeded weights, made on the device in one draw, for the reference's
modules; the same state dict is loaded into the program and the reference.

Each tensor is uniform around a centre: a tensor that the reference
module's ``INIT`` names, for the class of the module that holds it, on its
rule (``reference/model.py``: norm scales 1 ± 0.1 and shifts ±0.1, PReLU
slopes 0.25 ± 0.05, the SRU's gate vectors ±0.1, BatchNorm running means
±0.1 and variances 1 ± 0.25); any other matrix or kernel U(±1/√fan_in)
(PyTorch's default initialisation), its bias likewise, and a vector beside
no matrix ±0.1. Batch counters stay 0.
"""
from __future__ import annotations

import math
from typing import Dict, List, Mapping, Tuple

import torch
from torch import nn

# module class -> {tensor name: (centre, half-width)}
Rules = Mapping[type, Mapping[str, Tuple[float, float]]]


def _plan(module: nn.Module, init: Rules) -> List[Tuple[str, tuple, float, float]]:
    """(name, shape, centre, half-width) for every floating tensor of
    ``module``'s state dict, in its order."""
    plan = []
    for mname, m in module.named_modules():
        fan_in = None
        w = getattr(m, "weight", None)
        if isinstance(w, torch.Tensor) and w.dim() >= 2:
            fan_in = w[0].numel()
        for pname, t in list(m.named_parameters(recurse=False)) + list(
                m.named_buffers(recurse=False)):
            name = f"{mname + '.' if mname else ''}{pname}"
            if not t.is_floating_point():
                continue
            rule = next((r[pname] for cls, r in init.items()
                         if isinstance(m, cls) and pname in r), None)
            if rule is not None:
                centre, half = rule
            elif t.dim() >= 2:
                centre, half = 0.0, 1.0 / math.sqrt(t[0].numel())
            else:  # a bias beside a matrix or kernel
                centre, half = 0.0, 1.0 / math.sqrt(fan_in) if fan_in else 0.1
            plan.append((name, tuple(t.shape), centre, half))
    return plan


def make_state(model: nn.Module, video: nn.Module, seed: int, device,
               init: Rules) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """The (model, video model) state dicts for ``seed``, float32 on
    ``device``, drawn with one generator call, on the reference module's
    rules ``init``."""
    plans = (_plan(model, init), _plan(video, init))
    total = sum(math.prod(shape) for plan in plans for _, shape, _, _ in plan)
    gen = torch.Generator(device=device).manual_seed(seed)
    draw = torch.rand(total, generator=gen, device=device) * 2.0 - 1.0
    states, at = [], 0
    for module, plan in zip((model, video), plans):
        state = {k: torch.zeros_like(v, device=device) for k, v in module.state_dict().items()
                 if not v.is_floating_point()}
        for name, shape, centre, half in plan:
            n = math.prod(shape)
            state[name] = draw[at:at + n].view(shape) * half + centre
            at += n
        states.append(state)
    return states[0], states[1]
