"""ShuffleNetV2 trunk for lip reading (reference
``src/models/videomodels/shufflenetv2.py``;
``rtfs_net_tpu/models/videomodels/shufflenetv2.py``). The video model uses
only ``features -> conv_last -> globalpool``: its Conv3d front-end takes the
place of ``conv1``/``maxpool``.

Parameter names are the reference's: the trunk is ``Sequential(features,
conv_last)`` (``trunk.0.{idx}``, ``trunk.1.{0,1}``) and each block's
branches are the reference's Sequentials, ``banch1`` = (dw conv, bn,
pw-linear conv, bn, relu) and ``banch2`` = (pw conv, bn, relu, dw conv, bn,
pw-linear conv, bn, relu), so a published state dict loads by name. Every
activation is a ReLU, whatever the front-end's ``relu_type``.

The stride-1 3x3 depthwise conv of each block that does not downsample
goes, for a CUDA tensor, through the stencil kernel (``ops/conv.py``).
"""
from __future__ import annotations

import torch
from torch import nn

from ...ops.conv import Conv, avg_pool
from ...ops.normalizations import BatchNorm2d

STAGE_OUT_CHANNELS = {
    0.5: [-1, 24, 48, 96, 192, 1024],
    1.0: [-1, 24, 116, 232, 464, 1024],
    1.5: [-1, 24, 176, 352, 704, 1024],
    2.0: [-1, 24, 244, 488, 976, 2048],
}
STAGE_REPEATS = (4, 8, 4)


def channel_shuffle(x, groups: int):
    """(B, C, H, W) with channel g·(C/groups) + i moved to i·groups + g."""
    B, C, H, W = x.shape
    return x.view(B, groups, C // groups, H, W).transpose(1, 2).reshape(B, C, H, W)


def _conv(inp: int, oup: int, kernel: int, stride: int = 1, groups: int = 1):
    return Conv(inp, oup, kernel, ndim=2, stride=stride, padding=kernel // 2, groups=groups,
                bias=False)


class InvertedResidual(nn.Module):
    """``benchmodel`` 1: half the channels pass, half go through ``banch2``;
    2 (downsampling): both branches see the whole input. Then the channel
    shuffle."""

    def __init__(self, inp: int, oup: int, stride: int, benchmodel: int):
        super().__init__()
        self.benchmodel = benchmodel
        inc = oup // 2
        if benchmodel == 2:
            self.banch1 = nn.Sequential(
                _conv(inp, inp, 3, stride, groups=inp), BatchNorm2d(inp),
                _conv(inp, inc, 1), BatchNorm2d(inc), nn.ReLU())
        cin = inc if benchmodel == 1 else inp
        self.banch2 = nn.Sequential(
            _conv(cin, inc, 1), BatchNorm2d(inc), nn.ReLU(),
            _conv(inc, inc, 3, stride, groups=inc), BatchNorm2d(inc),
            _conv(inc, inc, 1), BatchNorm2d(inc), nn.ReLU())

    def forward(self, x):
        if self.benchmodel == 1:
            x1, x2 = x.chunk(2, dim=1)
            out = torch.cat((x1, self.banch2(x2)), dim=1)
        else:
            out = torch.cat((self.banch1(x), self.banch2(x)), dim=1)
        return channel_shuffle(out, 2)


class ShuffleNetV2Trunk(nn.Sequential):
    """(B', 24, H, W) front-end output -> (B', STAGE_OUT_CHANNELS[w][-1]):
    the three stages, the 1x1 ``conv_last`` and an average pool of
    ``input_size // 32`` (the reference's ``globalpool``)."""

    def __init__(self, input_size: int = 96, width_mult: float = 1.0):
        chans = STAGE_OUT_CHANNELS[width_mult]
        blocks, cin = [], chans[1]
        for stage, repeats in enumerate(STAGE_REPEATS):
            for i in range(repeats):
                blocks.append(InvertedResidual(cin, chans[stage + 2], 2 if i == 0 else 1,
                                               2 if i == 0 else 1))
                cin = chans[stage + 2]
        super().__init__(nn.Sequential(*blocks),
                         nn.Sequential(_conv(cin, chans[-1], 1), BatchNorm2d(chans[-1]),
                                       nn.ReLU()))
        self.pool = input_size // 32

    def forward(self, x):
        return avg_pool(super().forward(x), (self.pool, self.pool)).flatten(1)
