"""TF-GridNet separator (Wang et al., "TF-GridNet: Integrating Full- and
Sub-Band Modeling for Speech Separation", arXiv:2211.12433).

A TFGridNetBlock on the (B, D, T, F) grid is its config-built layers in
order, each with its own residual: the intra-frame BLSTM over F on
unfolded windows (a DualPathRNN with ``dim: 4``), the sub-band BLSTM over
T (``dim: 3``) and full-band self-attention over T with (E·F)-wide
queries and keys (MultiHeadSelfAttention2D). Unlike a DPTNetBlock it has no
gateway, projection or residual conv around them. ``TFGridNet`` repeats
the blocks (``RepeatedBlocks``: one block per repeat unless ``shared``,
checkpointed when training).
"""
from __future__ import annotations

from typing import Dict

from torch import nn

from .repeats import RepeatedBlocks
from ..layers import build


class TFGridNetBlock(nn.Module):
    def __init__(self, in_chan: int, layers: Dict[str, dict]):
        super().__init__()
        self.layers = nn.Sequential(*(
            build(conf["layer_type"], in_chan=in_chan,
                  **{k: v for k, v in conf.items() if k != "layer_type"})
            for conf in layers.values()))

    def forward(self, x):
        return self.layers(x)


class TFGridNet(RepeatedBlocks):
    def __init__(self, in_chan: int, layers: Dict[str, dict], repeats: int = 6,
                 shared: bool = False):
        super().__init__(lambda: TFGridNetBlock(in_chan, layers), repeats, shared, remat=True)
