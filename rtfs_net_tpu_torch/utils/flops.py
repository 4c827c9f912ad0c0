"""Parameter and multiply-accumulate counts (``rtfs_net_tpu/utils/flops.py``;
reference: thop's accounting, ``base_av_model.py:61-118``).

``conv_dot_macs`` counts the convolutions' and matmuls' multiply-accumulates
of one forward, as the JAX function of that name does with
``thop_equivalent=True`` (thop's hooks see convolutions and linear layers;
the JAX count adds the attention and SRU-projection matmuls, and so does
this one). The JAX package's selection matmuls for interpolation and
pooling are a TPU lowering the port does not have, so there is nothing to
leave out here. The count reads the ATen convolutions and matmuls of one
forward of a CPU copy of the model: there every kernel wrapper runs its
plain version and every conv goes to ATen, so the count is the same
whatever device the model is on (on the card K1 and K3 are calls ATen
does not see).
"""
from __future__ import annotations

import copy
import math

import torch
from torch.utils._python_dispatch import TorchDispatchMode


def count_params(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def _convolution(out, x, w, bias, stride, padding, dilation, transposed, output_padding,
                 groups):
    if transposed:  # w: (I, O/g, *k)
        return out.numel() * (w.shape[0] // groups) * math.prod(w.shape[2:])
    return out.numel() * math.prod(w.shape[1:])  # w: (O, I/g, *k)


def _matmul(out, a, b):
    return out.numel() * a.shape[-1]


def _matmul_add(out, bias, a, b, **kwargs):
    return out.numel() * a.shape[-1]


_aten = torch.ops.aten
_RULES = {_aten.convolution.default: _convolution, _aten.mm.default: _matmul,
          _aten.bmm.default: _matmul, _aten.addmm.default: _matmul_add,
          _aten.baddbmm.default: _matmul_add}


class _MacCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.macs = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        rule = _RULES.get(func)
        if rule is not None:
            self.macs += rule(out, *args, **(kwargs or {}))
        return out


def conv_dot_macs(model: torch.nn.Module, *example_inputs) -> int:
    """Convolution and matmul multiply-accumulates of ``model(*example_inputs)``
    (zeros of the inputs' shapes and dtypes; None passes through), counted
    on a CPU copy of the model."""
    cpu = copy.deepcopy(model).cpu().eval()
    inputs = [None if x is None else torch.zeros(x.shape, dtype=x.dtype)
              for x in example_inputs]
    counter = _MacCounter()
    with torch.no_grad(), counter:
        cpu(*inputs)
    return counter.macs


def model_macs_report(model: torch.nn.Module, *example_inputs) -> str:
    """Parameters per top-level module, MACs of ``model(*example_inputs)``
    and the parameter total, as a table (the reference prints one on every
    build, ``base_av_model.py:61-118``)."""
    rows = [(name, count_params(child)) for name, child in model.named_children()]
    width = max((len(n) for n, _ in rows), default=10)
    lines = [f"{'module':<{width}}  params(K)"]
    lines += [f"{name:<{width}}  {n / 1e3:9.1f}" for name, n in rows]
    lines.append(f"MACs (example input): {conv_dot_macs(model, *example_inputs) / 1e9:.2f} G")
    lines.append(f"Params total: {count_params(model) / 1e6:.3f} M")
    return "\n".join(lines)
