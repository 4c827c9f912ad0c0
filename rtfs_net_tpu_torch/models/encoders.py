"""Audio encoders (reference ``src/models/TDAVNet/encoder.py``): the
CTCNet time-domain conv bank and the RTFS-Net STFT front-end."""
from __future__ import annotations

import math
from typing import Any

import torch
from torch import nn
import torch.nn.functional as F

from .layers import ConvNormAct
from ..ops import stft as stft_ops


def unsqueeze_to_3d(x):
    """(L,) -> (1, 1, L); (B, L) -> (B, 1, L); (B, 1, L) as it is."""
    if x.dim() == 1:
        return x.reshape(1, 1, -1)
    return x[:, None] if x.dim() == 2 else x


def unsqueeze_to_2d(x):
    """(L,) -> (1, L); (B, 1, L) -> (B, L); (B, L) as it is."""
    if x.dim() == 1:
        return x.reshape(1, -1)
    if x.dim() == 3:
        assert x.shape[1] == 1
        return x.reshape(x.shape[0], -1)
    return x


def pad_to_multiple(x, lcm: int):
    """Zero-pad the last dim up to a multiple of ``lcm`` (a Python int from
    the static shape, so an exported program pads by a constant)."""
    rem = x.shape[-1] % lcm
    return F.pad(x, (0, lcm - rem)) if rem else x


class ConvolutionalEncoder(nn.Module):
    """Time-domain bank (``encoder.py:58-119``): ``layers`` dilated Conv1d
    branches (``encoder.{i}``: kernel k·(i+1), dilation i+1, xavier init)
    summed, after padding the input to a multiple of ``lcms[0]``, then of
    ``lcms[1]``, so that the separator's pyramid of ``upsampling_depth``
    halvings divides the frames."""

    def __init__(self, in_chan: int, out_chan: int, kernel_size: int, stride: int,
                 act_type: Any = None, norm_type: Any = "gLN", bias: bool = False,
                 layers: int = 1, upsampling_depth: int = 4):
        super().__init__()
        self.kernel_size, self.out_chan, self.upsampling_depth = (kernel_size, out_chan,
                                                                  upsampling_depth)
        self.encoder = nn.ModuleList(
            ConvNormAct(in_chan, out_chan, kernel_size * (i + 1), stride=stride,
                        dilation=i + 1, norm_type=norm_type, act_type=act_type,
                        xavier_init=True, bias=bias)
            for i in range(layers))

    @property
    def lcms(self):
        k2, up2 = self.kernel_size // 2, 2 ** self.upsampling_depth
        g = math.gcd(k2, up2)
        return abs(self.out_chan // 2 * up2) // g, abs(k2 * up2) // g

    def forward(self, x):
        x = unsqueeze_to_3d(x)
        lcm_1, lcm_2 = self.lcms
        x = pad_to_multiple(pad_to_multiple(x, lcm_1), lcm_2)
        return sum(branch(x) for branch in self.encoder)


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
        x = unsqueeze_to_2d(x)
        re, im = stft_ops.stft(x, self.win, self.hop_length)  # (B, F, T) each
        spec = torch.stack([re, im], dim=1).transpose(2, 3).to(x.dtype)
        return self.conv(spec)


_REGISTRY = {"ConvolutionalEncoder": ConvolutionalEncoder, "STFTEncoder": STFTEncoder}


def get(identifier):
    cls = _REGISTRY.get(identifier) if isinstance(identifier, str) else None
    if cls is None:
        raise ValueError(f"Could not interpret encoder identifier: {identifier}")
    return cls
