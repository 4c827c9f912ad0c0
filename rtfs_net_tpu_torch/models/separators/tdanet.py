"""TDANet separator, the RTFS block container
(reference ``src/models/separators/tdanet.py``).

A TDANetBlock is: gateway depthwise 1x1 -> projection 1x1 -> strided
depthwise downsample pyramid -> adaptive-pool sum -> the config-built
global-attention stack (RTFS: DualPathRNN along F, DualPathRNN along T,
MHSA2D) -> per-scale InjectionMultiSum reconstruction -> residual conv.

In training mode every block call is checkpointed (the JAX package's
``remat=True``; ``repeats.py``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from torch import nn

from .repeats import RepeatedBlocks
from ..layers import ConvNormAct, InjectionMultiSum, build
from ...ops.conv import adaptive_avg_pool
from ...utils.profiling import span


class TDANetBlock(nn.Module):
    def __init__(self, in_chan: int, hid_chan: int, kernel_size: int = 5,
                 stride: int = 2, norm_type: Any = "gLN", act_type: Any = "PReLU",
                 upsampling_depth: int = 4, layers: Optional[Dict[str, dict]] = None,
                 is2d: bool = False):
        super().__init__()
        self.depth = upsampling_depth
        self.gateway = ConvNormAct(in_chan, in_chan, 1, groups=in_chan,
                                   act_type=act_type, is2d=is2d)
        self.projection = ConvNormAct(in_chan, hid_chan, 1, norm_type=norm_type,
                                      act_type=act_type, is2d=is2d)
        self.downsample_layers = nn.ModuleList(
            ConvNormAct(hid_chan, hid_chan, kernel_size, stride=1 if i == 0 else stride,
                        groups=hid_chan, norm_type=norm_type, is2d=is2d)
            for i in range(upsampling_depth))
        self.globalatt = nn.Sequential(*(
            build(conf["layer_type"], in_chan=hid_chan,
                  **{k: v for k, v in conf.items() if k != "layer_type"})
            for conf in (layers or {}).values()))

        def inj():
            return InjectionMultiSum(hid_chan, kernel_size, norm_type, is2d=is2d)

        self.fusion_layers = nn.ModuleList(inj() for _ in range(upsampling_depth))
        self.concat_layers = nn.ModuleList(inj() for _ in range(upsampling_depth - 1))
        self.residual_conv = ConvNormAct(hid_chan, in_chan, 1, is2d=is2d)

    def forward(self, x):
        with span("rtfs.refine.pyramid"):
            residual = self.gateway(x)
            downsampled = [self.downsample_layers[0](self.projection(residual))]
            for layer in self.downsample_layers[1:]:
                downsampled.append(layer(downsampled[-1]))
            target = downsampled[-1].shape[2:]
            global_features = sum(adaptive_avg_pool(f, target) for f in downsampled)
        global_features = self.globalatt(global_features)
        with span("rtfs.refine.reconstruct"):
            fused = [self.fusion_layers[i](downsampled[i], global_features)
                     for i in range(self.depth)]
            expanded = self.concat_layers[-1](fused[-2], fused[-1]) + downsampled[-2]
            for i in range(self.depth - 3, -1, -1):
                expanded = self.concat_layers[i](fused[i], expanded) + downsampled[i]
            return self.residual_conv(expanded) + residual


class TDANet(RepeatedBlocks):
    """Repeat container (``tdanet.py:136-211``): ``shared=True`` reuses one
    block (``blocks``), else one block per repeat (``blocks.{i}``); with
    ``remat`` (the default, as in JAX) a block that trains under autograd
    is checkpointed (``repeats.RepeatedBlocks``)."""

    def __init__(self, in_chan: int = -1, hid_chan: int = -1, kernel_size: int = 5,
                 stride: int = 2, norm_type: Any = "gLN", act_type: Any = "PReLU",
                 upsampling_depth: int = 4, layers: Optional[Dict[str, dict]] = None,
                 repeats: int = 4, shared: bool = False, is2d: bool = False,
                 remat: bool = True):
        def block():
            return TDANetBlock(in_chan, hid_chan, kernel_size, stride, norm_type,
                               act_type, upsampling_depth, layers, is2d)

        super().__init__(block, repeats, shared, remat, in_chan > 0 and hid_chan > 0)
