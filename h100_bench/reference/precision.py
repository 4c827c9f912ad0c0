"""The precision the reference computes in. ``float32`` is the reference
itself; the controls put it in the program's place one step lower:
``bfloat16`` (parameters and activations in bfloat16) and ``fp8`` (on a
bfloat16 model, every matmul and convolution operand and every layer's
output rounded to float8 e4m3 with one scale per tensor, and the gradient
flowing back into each to float8 e5m2, the two formats of fp8 training)."""
from __future__ import annotations

import contextlib

import torch

E4M3_MAX, E5M2_MAX = 448.0, 57344.0
_MODE = ["float32"]
# a cell's control: the precision one step below the one its traffic runs in
BELOW = {"float32": "bfloat16", "bfloat16": "fp8"}


@contextlib.contextmanager
def mode(name: str):
    if name not in ("float32", "bfloat16", "fp8"):
        raise ValueError(f"unknown precision {name!r}")
    previous, _MODE[0] = _MODE[0], name
    try:
        yield
    finally:
        _MODE[0] = previous


def current() -> str:
    return _MODE[0]


def dtype() -> torch.dtype:
    """The dtype the reference's parameters and activations take."""
    return torch.float32 if _MODE[0] == "float32" else torch.bfloat16


def _round(x: torch.Tensor, fmt: torch.dtype, largest: float) -> torch.Tensor:
    """``x`` rounded to ``fmt`` at the scale that maps its largest
    magnitude to ``largest``, in ``x``'s dtype."""
    scale = x.abs().amax().float().clamp(min=1e-30) / largest
    return ((x.float() / scale).to(fmt).float() * scale).to(x.dtype)


class _FP8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, E5M2_MAX)


def q(x: torch.Tensor) -> torch.Tensor:
    """An operand of a matmul or convolution, or a layer's output: as it is,
    or under ``fp8`` rounded to e4m3 (its gradient to e5m2)."""
    return _FP8.apply(x) if _MODE[0] == "fp8" else x


@contextlib.contextmanager
def layer_outputs(module: torch.nn.Module):
    """Under ``fp8``, round the output of every layer (every module without
    children) of ``module`` inside the block, as ``q`` rounds operands."""
    if _MODE[0] != "fp8":
        yield
        return
    hooks = [m.register_forward_hook(lambda _m, _a, out: q(out) if torch.is_tensor(out)
                                     and out.is_floating_point() else out)
             for m in module.modules() if next(m.children(), None) is None]
    try:
        yield
    finally:
        for h in hooks:
            h.remove()
