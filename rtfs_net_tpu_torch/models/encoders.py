"""Audio encoder (reference ``src/models/TDAVNet/encoder.py``), limited to
the RTFS-Net STFT front-end."""
from __future__ import annotations

from typing import Any

import torch
from torch import nn

from .layers import ConvNormAct
from ..ops import stft as stft_ops


class STFTEncoder(nn.Module):
    """STFT (Hann, onesided, centred) -> Re/Im stacked as (B, 2, T, F) ->
    2-D ConvNormAct to ``out_chan`` (``encoder.py:122-175``)."""

    def __init__(self, win: int, hop_length: int, out_chan: int = 2,
                 kernel_size: int = -1, stride: int = 1, act_type: Any = "ReLU",
                 norm_type: Any = "gLN", bias: bool = False):
        super().__init__()
        self.win, self.hop_length, self.out_chan = win, hop_length, out_chan
        self.conv = ConvNormAct(2, out_chan, kernel_size, stride=stride, act_type=act_type,
                                norm_type=norm_type, xavier_init=True, bias=bias, is2d=True)

    def forward(self, x):
        x = x.reshape(-1, x.shape[-1])  # (B, L); a (B, 1, L) or (L,) input folds
        re, im = stft_ops.stft(x, self.win, self.hop_length)  # (B, F, T) each
        spec = torch.stack([re, im], dim=1).transpose(2, 3).to(x.dtype)
        return self.conv(spec)


_REGISTRY = {"STFTEncoder": STFTEncoder}


def get(identifier):
    cls = _REGISTRY.get(identifier) if isinstance(identifier, str) else None
    if cls is None:
        raise ValueError(f"Could not interpret encoder identifier: {identifier}")
    return cls
