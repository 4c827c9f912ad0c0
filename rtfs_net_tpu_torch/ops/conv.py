"""Convolutions on channel-first tensors with torch's weight layouts
(Conv: (O, I/g, *k); ConvTranspose: (I, O/g, *k); Linear: (O, I)).

Parameters stay float32 and are cast to the activation's dtype at each
call, as the JAX package does, so one module serves float32 and bfloat16
inputs. ``padding="same"`` is torch's own: for an even kernel it pads
``total // 2`` on the left and the rest on the right, which is what the
reference relies on (``conv_layers.py:100-101``).

A stride-1 depthwise k x k 2-D conv that keeps its input's size runs, for
a CUDA tensor, through the hand-written stencil kernel
(``kernels/dw_conv.py``), which handles the edges itself; every other conv,
and every conv of a CPU tensor, goes to ``F.conv{1,2,3}d``.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import torch
from torch import nn
import torch.nn.functional as F

from .dropout import keep_mask
from .kernels.dw_conv import dw_conv2d_same, dw_conv_supported

IntOrTuple = Union[int, Sequence[int]]

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
# device types whose eligible depthwise convs go to the stencil kernel's
# wrapper (on "cpu" the wrapper would run its plain version, which is for tests)
DW_KERNEL_DEVICES = ("cuda",)
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d}


def _to_tuple(v: IntOrTuple, ndim: int) -> Tuple[int, ...]:
    if isinstance(v, (list, tuple)):
        assert len(v) == ndim, (v, ndim)
        return tuple(int(x) for x in v)
    return (int(v),) * ndim


def _resolve_padding(padding, kernel, dilation):
    """Per-dim (lo, hi) zero padding. ``"same"`` pads ``total // 2`` before
    and the rest after, torch's rule for an even kernel
    (``rtfs_net_tpu/ops/conv.py:_resolve_padding``)."""
    if padding == "valid":
        return tuple((0, 0) for _ in kernel)
    if padding != "same":
        return tuple((p, p) for p in _to_tuple(padding, len(kernel)))
    return tuple((d * (k - 1) // 2, d * (k - 1) - d * (k - 1) // 2)
                 for k, d in zip(kernel, dilation))


def _uniform_(t, bound: float, generator):
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=generator)


class _Weighted(nn.Module):
    """A weight of ``wshape`` plus an optional bias, initialised like torch
    (kaiming-uniform a=sqrt(5): U(±1/sqrt(fan_in)) for both) or with
    xavier-uniform on the weight."""

    def __init__(self, wshape, n_out: int, fan_in: int, fan_out: int,
                 bias: bool, xavier_init: bool):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(wshape))
        self.bias = nn.Parameter(torch.empty(n_out)) if bias else None
        self._fans = (fan_in, fan_out)
        self.xavier_init = xavier_init
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        fan_in, fan_out = self._fans
        bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
        wbound = math.sqrt(6.0 / (fan_in + fan_out)) if self.xavier_init else bound
        _uniform_(self.weight, wbound, generator)
        if self.bias is not None:
            _uniform_(self.bias, bound, generator)

    def _params(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return self.weight.to(x.dtype), b


class Conv(_Weighted):
    """torch ``nn.Conv{1,2,3}d`` on (B, C, *spatial)."""

    def __init__(self, in_chan: int, out_chan: int, kernel_size: IntOrTuple,
                 ndim: int = 1, stride: IntOrTuple = 1,
                 padding: Union[str, IntOrTuple] = 0, dilation: IntOrTuple = 1,
                 groups: int = 1, bias: bool = True, xavier_init: bool = False):
        kernel = _to_tuple(kernel_size, ndim)
        rec = math.prod(kernel)
        self.ndim, self.groups = ndim, groups
        self.stride = _to_tuple(stride, ndim)
        self.dilation = _to_tuple(dilation, ndim)
        self.in_chan, self.out_chan, self.kernel = in_chan, out_chan, kernel
        self.pads = _resolve_padding(padding, kernel, self.dilation)
        if all(lo == hi for lo, hi in self.pads):
            self.pad, self.padding = None, tuple(lo for lo, _ in self.pads)
        else:  # F.pad lists the last dim first
            self.pad = tuple(p for lo_hi in reversed(self.pads) for p in lo_hi)
            self.padding = 0
        super().__init__((out_chan, in_chan // groups, *kernel), out_chan,
                         (in_chan // groups) * rec, out_chan * rec, bias, xavier_init)

    def takes_dw_kernel(self, x) -> bool:
        """Whether ``x`` goes through the stencil kernel's wrapper."""
        return x.device.type in DW_KERNEL_DEVICES and dw_conv_supported(
            tuple(x.shape), self.kernel, self.stride, self.dilation, self.groups,
            self.in_chan, self.out_chan, self.ndim, self.pads)

    def forward(self, x):
        if self.takes_dw_kernel(x):
            # float32 weights, as the JAX route has them; the bias is added outside
            y = dw_conv2d_same(x, self.weight, self.pads)
            if self.bias is not None:
                y = y + self.bias.to(x.dtype).view(1, -1, 1, 1)
            return y
        w, b = self._params(x)
        if self.pad is not None:
            x = F.pad(x, self.pad)
        return _CONV[self.ndim](x, w, b, self.stride, self.padding,
                                self.dilation, self.groups)


class ConvTranspose(_Weighted):
    """torch ``nn.ConvTranspose{1,2}d`` on (B, C, *spatial)."""

    def __init__(self, in_chan: int, out_chan: int, kernel_size: IntOrTuple,
                 ndim: int = 1, stride: IntOrTuple = 1, padding: IntOrTuple = 0,
                 output_padding: IntOrTuple = 0, dilation: IntOrTuple = 1,
                 groups: int = 1, bias: bool = True, xavier_init: bool = False):
        kernel = _to_tuple(kernel_size, ndim)
        rec = math.prod(kernel)
        self.ndim, self.groups = ndim, groups
        self.stride = _to_tuple(stride, ndim)
        self.padding = _to_tuple(padding, ndim)
        self.output_padding = _to_tuple(output_padding, ndim)
        self.dilation = _to_tuple(dilation, ndim)
        super().__init__((in_chan, out_chan // groups, *kernel), out_chan,
                         (out_chan // groups) * rec, in_chan * rec, bias, xavier_init)

    def forward(self, x):
        w, b = self._params(x)
        return _CONV_T[self.ndim](x, w, b, self.stride, self.padding,
                                  self.output_padding, self.groups, self.dilation)


class Linear(_Weighted):
    """torch ``nn.Linear``; weight (O, I)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True):
        super().__init__((out_features, in_features), out_features, in_features,
                         out_features, bias, False)

    def forward(self, x):
        w, b = self._params(x)
        return F.linear(x, w, b)


def interpolate_nearest(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """torch ``F.interpolate(mode="nearest")``: src = floor(dst * in/out)."""
    size = tuple(int(s) for s in size)
    if tuple(x.shape[2:]) == size:
        return x
    return F.interpolate(x, size=size, mode="nearest")


def adaptive_avg_pool(x: torch.Tensor, output_size: Sequence[int]) -> torch.Tensor:
    """torch ``F.adaptive_avg_pool{1,2}d`` on (B, C, *spatial)."""
    output_size = tuple(int(s) for s in output_size)
    if tuple(x.shape[2:]) == output_size:
        return x
    pool = F.adaptive_avg_pool1d if x.dim() == 3 else F.adaptive_avg_pool2d
    return pool(x, output_size)


def avg_pool(x: torch.Tensor, kernel: Sequence[int], stride: Sequence[int] | None = None,
             ceil_mode: bool = False, count_include_pad: bool = True) -> torch.Tensor:
    """torch ``F.avg_pool2d`` (no padding) on (B, C, H, W)
    (``rtfs_net_tpu/ops/conv.py:avg_pool``)."""
    kernel = tuple(kernel)
    return F.avg_pool2d(x, kernel, tuple(stride) if stride is not None else kernel,
                        ceil_mode=ceil_mode, count_include_pad=count_include_pad)


def max_pool(x: torch.Tensor, kernel: Sequence[int], stride: Sequence[int],
             padding: Sequence[int]) -> torch.Tensor:
    """torch ``F.max_pool{1,2,3}d`` (symmetric padding with -inf) on
    (B, C, *spatial)."""
    return _MAX_POOL[len(kernel)](x, tuple(kernel), tuple(stride), tuple(padding))


def unfold_1d(x: torch.Tensor, kernel_size: int, stride: int = 1) -> torch.Tensor:
    """``nn.Unfold((k, 1), stride=(s, 1))`` on (B, C, T): (B, C·k, L) with
    rows ordered ``c*k + tap`` (the DualPathRNN windowing)."""
    B, C, _ = x.shape
    y = x.unfold(2, kernel_size, stride)  # (B, C, L, k)
    return y.permute(0, 1, 3, 2).reshape(B, C * kernel_size, -1)


class DropPath(nn.Module):
    """Per-sample stochastic depth (``rtfs_net_tpu/ops/conv.py:DropPath``):
    in training mode, zero a whole sample with probability p and scale the
    kept samples by 1/(1-p); the identity in eval mode."""

    def __init__(self, p: float = 0.0):
        super().__init__()
        self.p = p

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        keep = 1.0 - self.p
        mask = keep_mask((x.shape[0],) + (1,) * (x.dim() - 1), keep, x.device)
        return torch.where(mask, x / keep, torch.zeros_like(x))
