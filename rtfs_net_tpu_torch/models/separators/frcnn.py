"""FRCNN separator, the CTCNet block container
(reference ``src/models/separators/frcnn.py``).

An FRCNNBlock is: gateway depthwise 1x1 -> projection 1x1 -> strided
depthwise downsample pyramid -> lateral fusion, where each scale
concatenates the finer scale's strided conv, itself and the coarser scale
upsampled, then a 1x1 ``concat{i}`` -> every scale resized to the finest
and merged by ``residual_conv.0/1`` -> plus the gateway's output.

In training mode every block call is checkpointed (the JAX package's
``remat=True``; ``repeats.py``), which also keeps a BatchNorm block's
running statistics from moving twice per step.
"""
from __future__ import annotations

from typing import Any

import torch
from torch import nn

from .repeats import RepeatedBlocks
from ..layers import ConvNormAct
from ...ops.conv import interpolate_nearest
from ...utils.profiling import span


class FRCNNBlock(nn.Module):
    def __init__(self, in_chan: int, hid_chan: int, kernel_size: int = 5,
                 stride: int = 2, norm_type: Any = "gLN", act_type: Any = "PReLU",
                 upsampling_depth: int = 4, is2d: bool = False):
        super().__init__()
        self.depth = upsampling_depth

        def dw(s):
            return ConvNormAct(hid_chan, hid_chan, kernel_size, stride=s, groups=hid_chan,
                               norm_type=norm_type, is2d=is2d)

        def merge(n_in):
            return ConvNormAct(n_in, hid_chan, 1, norm_type=norm_type, act_type=act_type,
                               is2d=is2d)

        self.gateway = ConvNormAct(in_chan, in_chan, 1, groups=in_chan, act_type=act_type,
                                   is2d=is2d)
        self.projection = ConvNormAct(in_chan, hid_chan, 1, is2d=is2d)
        self.downsample_layers = nn.ModuleList(dw(1 if i == 0 else stride)
                                               for i in range(upsampling_depth))
        # the lateral strided conv from the next finer scale (none at scale 0)
        self.fusion_layers = nn.ModuleList(nn.ModuleList([dw(stride)] if i else [])
                                           for i in range(upsampling_depth))
        self.concat_layers = nn.ModuleList(
            merge(hid_chan * (1 + (i > 0) + (i < upsampling_depth - 1)))
            for i in range(upsampling_depth))
        self.residual_conv = nn.Sequential(merge(hid_chan * upsampling_depth),
                                           ConvNormAct(hid_chan, in_chan, 1, is2d=is2d))

    def forward(self, x):
        with span("rtfs.refine.pyramid"):
            residual = self.gateway(x)
            downsampled = [self.downsample_layers[0](self.projection(residual))]
            for layer in self.downsample_layers[1:]:
                downsampled.append(layer(downsampled[-1]))
        with span("rtfs.refine.reconstruct"):
            fused = []
            for i, here in enumerate(downsampled):
                parts = ([self.fusion_layers[i][0](downsampled[i - 1])] if i else []) + [here]
                if i + 1 < self.depth:
                    parts.append(interpolate_nearest(downsampled[i + 1], here.shape[2:]))
                fused.append(self.concat_layers[i](torch.cat(parts, dim=1)))
            target = downsampled[0].shape[2:]
            merged = torch.cat([fused[0]] + [interpolate_nearest(f, target) for f in fused[1:]],
                               dim=1)
            return self.residual_conv(merged) + residual


class FRCNN(RepeatedBlocks):
    """Repeat container: ``shared=True`` reuses one block (``blocks``), else
    one block per repeat (``blocks.{i}``); with ``remat`` (the default, as
    in JAX) a block that trains under autograd is checkpointed
    (``repeats.RepeatedBlocks``)."""

    def __init__(self, in_chan: int = -1, hid_chan: int = -1, kernel_size: int = 5,
                 stride: int = 2, norm_type: Any = "gLN", act_type: Any = "PReLU",
                 upsampling_depth: int = 4, repeats: int = 4, shared: bool = False,
                 is2d: bool = False, remat: bool = True):
        def block():
            return FRCNNBlock(in_chan, hid_chan, kernel_size, stride, norm_type, act_type,
                              upsampling_depth, is2d)

        super().__init__(block, repeats, shared, remat, in_chan > 0 and hid_chan > 0)
