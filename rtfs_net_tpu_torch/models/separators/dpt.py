"""DPTNet separator (reference ``src/models/separators/dpt.py``): a
gateway and a projection conv around a config-built stack of global
layers (``globalatt``), a residual conv and a residual, repeated by
``RepeatedBlocks`` (shared or one block per repeat, checkpointed when
training; the identity without ``in_chan``)."""
from __future__ import annotations

from typing import Dict, Optional

from torch import nn

from .repeats import RepeatedBlocks
from ..layers import ConvNormAct, build


class DPTNetBlock(nn.Module):
    def __init__(self, in_chan: int, hid_chan: int,
                 layers: Optional[Dict[str, dict]] = None, is2d: bool = False):
        super().__init__()
        self.gateway = ConvNormAct(in_chan, in_chan, 1, groups=in_chan, act_type="PReLU",
                                   is2d=is2d)
        self.projection = ConvNormAct(in_chan, hid_chan, 1, is2d=is2d)
        self.globalatt = nn.Sequential(*(
            build(conf["layer_type"], in_chan=hid_chan,
                  **{k: v for k, v in conf.items() if k != "layer_type"})
            for conf in (layers or {}).values()))
        self.residual_conv = ConvNormAct(hid_chan, in_chan, 1, is2d=is2d)

    def forward(self, x):
        residual = self.gateway(x)
        return self.residual_conv(self.globalatt(self.projection(residual))) + residual


class DPTNet(RepeatedBlocks):
    def __init__(self, in_chan: int = -1, hid_chan: int = -1,
                 layers: Optional[Dict[str, dict]] = None, repeats: int = 4,
                 shared: bool = False, is2d: bool = False, remat: bool = True):
        def block():
            return DPTNetBlock(in_chan, hid_chan, layers, is2d)

        super().__init__(block, repeats, shared, remat, in_chan > 0)
