"""DualPathRNN (reference ``src/models/layers/rnn_layers.py:62-162``), the
RTFS core: k-sample windows along one TF axis, a (bi)SRU over the window
sequence with the other axis folded into the batch, and a ConvTranspose
overlap-add back to C channels with a residual."""
from __future__ import annotations

import math
from typing import Any

import torch.nn.functional as F
from torch import nn

from ...ops.conv import ConvTranspose
from ...ops.rnn import SRU
from .conv_blocks import make_norm


class DualPathRNN(nn.Module):
    """``dim=4`` runs the recurrence along F, ``dim=3`` along T. Both axes
    are padded up to the unfold grid; the windows are never materialized
    (the SRU's layer-0 projection is a k-wide conv, ``ops/rnn.py``)."""

    def __init__(self, in_chan: int, hid_chan: int, dim: int, kernel_size: int = 8,
                 stride: int = 1, rnn_type: str = "LSTM", num_layers: int = 1,
                 norm_type: Any = "LayerNormalization4D", bidirectional: bool = True,
                 apply_ffn: bool = False):
        super().__init__()
        if rnn_type != "SRU" or apply_ffn:
            raise NotImplementedError(
                f"DualPathRNN rnn_type={rnn_type!r}, apply_ffn={apply_ffn} is not ported yet")
        self.dim, self.kernel_size, self.stride = dim, kernel_size, stride
        num_dir = 2 if bidirectional else 1
        self.norm = make_norm(norm_type, in_chan, 1)
        self.rnn = SRU(in_chan * kernel_size, hid_chan, num_layers, bidirectional)
        self.linear = ConvTranspose(hid_chan * num_dir, in_chan, kernel_size, ndim=1,
                                    stride=stride)

    def forward(self, x):
        if self.dim == 4:
            x = x.transpose(-2, -1)
        B, C, old_T, old_F = x.shape
        k, s = self.kernel_size, self.stride
        new_T = int(math.ceil((old_T - k) / s) * s + k)
        new_F = int(math.ceil((old_F - k) / s) * s + k)
        x = F.pad(x, (0, new_F - old_F, 0, new_T - old_T))
        residual = x
        y = self.norm(x)
        y = y.permute(0, 3, 1, 2).reshape(B * new_F, C, new_T)
        y = self.rnn(y, window=(k, s))         # (L, B·F, O)
        y = self.linear(y.permute(1, 2, 0))    # (B·F, C, new_T)
        y = y.reshape(B, new_F, C, new_T).permute(0, 2, 3, 1)
        y = (y + residual)[..., :old_T, :old_F]
        if self.dim == 4:
            y = y.transpose(-2, -1)
        return y
