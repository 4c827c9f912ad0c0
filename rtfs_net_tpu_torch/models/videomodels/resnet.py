"""Headless ResNet-18 trunk for lip reading (reference
``src/models/videomodels/resnet.py``: the four layers and a global
average pool, no classification head), with the reference's parameter
names: ``layer{1-4}.{block}.conv1/bn1/relu1/conv2/bn2/relu2`` and
``downsample.0`` (conv), ``downsample.1`` (BatchNorm)."""
from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from ...ops.activations import PReLU
from ...ops.conv import Conv
from ...ops.normalizations import BatchNorm2d


class _TrunkConv(Conv):
    """A bias-free 2-D conv with the reference trunk's initialisation:
    N(0, 2 / (k·k·out_chan))."""

    def __init__(self, in_chan: int, out_chan: int, kernel_size: int, stride: int,
                 padding: int):
        super().__init__(in_chan, out_chan, kernel_size, ndim=2, stride=stride,
                         padding=padding, bias=False)

    def reset_parameters(self, generator=None):
        std = math.sqrt(2.0 / (math.prod(self.kernel) * self.out_chan))
        with torch.no_grad():
            self.weight.normal_(0.0, std, generator=generator)


def activation(relu_type: str, chan: int) -> nn.Module:
    """The reference's ``relu_type``: a per-channel PReLU or a ReLU."""
    if relu_type == "prelu":
        return PReLU(num_parameters=chan)
    if relu_type == "relu":
        return nn.ReLU()
    raise ValueError(f"relu_type must be 'relu' or 'prelu', got {relu_type!r}")


class BasicBlock(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 has_downsample: bool = False, relu_type: str = "relu"):
        super().__init__()
        self.conv1 = _TrunkConv(inplanes, planes, 3, stride, 1)
        self.bn1 = BatchNorm2d(planes)
        self.relu1 = activation(relu_type, planes)
        self.conv2 = _TrunkConv(planes, planes, 3, 1, 1)
        self.bn2 = BatchNorm2d(planes)
        self.relu2 = activation(relu_type, planes)
        self.downsample = (nn.Sequential(_TrunkConv(inplanes, planes, 1, stride, 0),
                                         BatchNorm2d(planes))
                           if has_downsample else None)

    def forward(self, x):
        out = self.relu1(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        residual = x if self.downsample is None else self.downsample(x)
        return self.relu2(out + residual)


class ResNet(nn.Module):
    """ResNet-18 trunk: (B', 64, H, W) -> (B', 512), the mean over H, W."""

    def __init__(self, layers: Sequence[int] = (2, 2, 2, 2), relu_type: str = "prelu"):
        super().__init__()
        inplanes = 64
        for i, (planes, blocks, stride) in enumerate(
                zip((64, 128, 256, 512), layers, (1, 2, 2, 2))):
            seq = []
            for b in range(blocks):
                s = stride if b == 0 else 1
                seq.append(BasicBlock(inplanes, planes, s,
                                      b == 0 and (s != 1 or inplanes != planes), relu_type))
                inplanes = planes
            setattr(self, f"layer{i + 1}", nn.Sequential(*seq))

    def forward(self, x):
        for i in range(1, 5):
            x = getattr(self, f"layer{i}")(x)
        return x.mean(dim=(2, 3))
