"""Composite conv blocks (reference ``src/models/layers/conv_layers.py``)
on channel-first tensors; ``is2d`` switches (B, C, T) and (B, C, T, F)."""
from __future__ import annotations

from typing import Any, Optional, Union

import torch
from torch import nn

from ...ops import activations, normalizations
from ...ops.conv import Conv, DropPath


def make_norm(norm_type, chan: int, n_freqs: int = -1) -> nn.Module:
    """A norm module from a registry string (LN4D takes (C, F))."""
    cls = normalizations.get(norm_type)
    if cls is normalizations.LayerNormalization4D:
        return cls(chan, n_freqs if n_freqs > 0 else 1)
    if cls is normalizations.Identity:
        return cls()
    return cls(chan)


def apply_norm(norm: nn.Module, x, train=None):
    """``norm(x)``. The JAX package passes ``train`` to pick a BatchNorm's
    statistics; here the module's own mode picks them, so ``train`` is
    not read."""
    return norm(x)


class ConvNormAct(nn.Module):
    """pre_norm -> pre_act -> conv -> norm -> act as the reference's
    ``full_layer`` Sequential (``conv_layers.py:65-139``). kernel <= 0 makes
    the conv an Identity and out_chan collapses to in_chan; stride > 1 pads
    ``dilation*(k-1)//2``, stride 1 pads torch-"same"."""

    def __init__(self, in_chan: int = 1, out_chan: int = 1, kernel_size: int = -1,
                 stride: int = 1, groups: int = 1, dilation: int = 1,
                 padding: Optional[Union[int, str]] = None, pre_norm_type: Any = None,
                 pre_act_type: Any = None, norm_type: Any = None, act_type: Any = None,
                 xavier_init: bool = False, bias: bool = True, is2d: bool = False):
        super().__init__()
        out_chan = out_chan if kernel_size > 0 else in_chan
        if padding is None:
            padding = dilation * (kernel_size - 1) // 2 if stride > 1 else "same"
        conv = (Conv(in_chan, out_chan, kernel_size, ndim=2 if is2d else 1,
                     stride=stride, padding=padding, dilation=dilation, groups=groups,
                     bias=bias, xavier_init=xavier_init)
                if kernel_size > 0 else nn.Identity())
        self.full_layer = nn.Sequential(
            make_norm(pre_norm_type, in_chan),
            activations.get(pre_act_type)(),
            conv,
            make_norm(norm_type, out_chan),
            activations.get(act_type)(),
        )

    def forward(self, x):
        return self.full_layer(x)


class ConvActNorm(nn.Module):
    """conv -> act -> norm (``conv_layers.py:142-215``); stride > 1 pads 0,
    stride 1 pads "same"; an LN4D norm takes (C, n_freqs)."""

    def __init__(self, in_chan: int = 1, out_chan: int = 1, kernel_size: int = -1,
                 stride: int = 1, groups: int = 1, dilation: int = 1,
                 padding: Optional[Union[int, str]] = None, norm_type: Any = None,
                 act_type: Any = None, n_freqs: int = -1, xavier_init: bool = False,
                 bias: bool = True, is2d: bool = False):
        super().__init__()
        if padding is None:
            padding = 0 if stride > 1 else "same"
        self.conv = (Conv(in_chan, out_chan, kernel_size, ndim=2 if is2d else 1,
                          stride=stride, padding=padding, dilation=dilation,
                          groups=groups, bias=bias, xavier_init=xavier_init)
                     if kernel_size > 0 else nn.Identity())
        self.act = activations.get(act_type)()
        self.norm = make_norm(norm_type, out_chan, n_freqs)

    def forward(self, x):
        return self.norm(self.act(self.conv(x)))


class FeedForwardNetwork(nn.Module):
    """1x1 expand -> depthwise refine -> 1x1 contract, residual
    (``conv_layers.py:218-259``), with DropPath after the refiner and
    after the decoder (one module, an independent mask at each call)."""

    def __init__(self, in_chan: int, hid_chan: int, kernel_size: int = 5,
                 norm_type: Any = "gLN", act_type: Any = "ReLU",
                 dropout: float = 0.0, is2d: bool = False):
        super().__init__()
        self.encoder = ConvNormAct(in_chan, hid_chan, 1, norm_type=norm_type,
                                   bias=False, is2d=is2d)
        self.refiner = ConvNormAct(hid_chan, hid_chan, kernel_size, groups=hid_chan,
                                   act_type=act_type, is2d=is2d)
        self.decoder = ConvNormAct(hid_chan, in_chan, 1, norm_type=norm_type,
                                   bias=False, is2d=is2d)
        self.drop_path = DropPath(dropout)

    def forward(self, x):
        y = self.drop_path(self.refiner(self.encoder(x)))
        return self.drop_path(self.decoder(y)) + x


class DepthwiseSeparableConvolution(nn.Module):
    """Depthwise conv, pointwise conv, then act and norm
    (``conv_layers.py:10-62``); the identity for kernel_size <= 0."""

    def __init__(self, in_chan: int, out_chan: int, kernel_size: int = -1,
                 stride: int = 1, norm_type: Any = None, act_type: Any = None,
                 xavier_init: bool = False, is2d: bool = False):
        super().__init__()
        ks = kernel_size[0] if hasattr(kernel_size, "__len__") else kernel_size
        self.identity = ks <= 0
        if self.identity:
            return
        self.depthwise_conv = ConvNormAct(in_chan, in_chan, kernel_size, stride=stride,
                                          groups=in_chan, xavier_init=xavier_init, is2d=is2d)
        self.pointwise_conv = ConvNormAct(in_chan, out_chan, 1, xavier_init=xavier_init,
                                          is2d=is2d)
        self.act = activations.get(act_type)()
        self.norm = make_norm(norm_type, out_chan)

    def forward(self, x):
        if self.identity:
            return x
        return self.norm(self.act(self.pointwise_conv(self.depthwise_conv(x))))


class ConvolutionalRNN(nn.Module):
    """A pseudo-RNN FFN (``conv_layers.py:262-316``): 1x1 expand, a
    depthwise conv of the sequence and one of the flipped sequence
    (the second's output stays flipped), concatenated, 1x1 contract,
    residual; DropPath as in ``FeedForwardNetwork``."""

    def __init__(self, in_chan: int, hid_chan: int, kernel_size: int = 5,
                 norm_type: Any = "gLN", act_type: Any = "ReLU",
                 dropout: float = 0.0, is2d: bool = False):
        super().__init__()
        self.encoder = ConvNormAct(in_chan, hid_chan, 1, norm_type=norm_type,
                                   bias=False, is2d=is2d)
        self.forward_pass = ConvNormAct(hid_chan, hid_chan, kernel_size, groups=hid_chan,
                                        act_type=act_type, is2d=is2d)
        self.backward_pass = ConvNormAct(hid_chan, hid_chan, kernel_size, groups=hid_chan,
                                         act_type=act_type, is2d=is2d)
        self.decoder = ConvNormAct(hid_chan * 2, in_chan, 1, norm_type=norm_type,
                                   bias=False, is2d=is2d)
        self.drop_path = DropPath(dropout)
        self.flip_dims = (2, 3) if is2d else (2,)

    def forward(self, x):
        y = self.encoder(x)
        y = torch.cat([self.forward_pass(y), self.backward_pass(y.flip(self.flip_dims))], 1)
        return self.drop_path(self.decoder(self.drop_path(y))) + x
