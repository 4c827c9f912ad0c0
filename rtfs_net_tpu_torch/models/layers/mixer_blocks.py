"""Patch-MLP layers of the legacy configs (reference
``src/models/layers/mlp.py`` and ``permutator.py``): MLP-Mixer and the
ViP Permutator on (B, C, T, F). The input is padded up to the patch grid
(always by at least one patch: the reference's rule), cut into p x p
patches, mixed, put back together and cropped."""
from __future__ import annotations

from typing import Sequence

import torch.nn.functional as F
from torch import nn

from ...ops.activations import GELU
from ...ops.conv import Linear
from ...ops.dropout import Dropout
from ...ops.normalizations import LayerNorm


def _patchify(x, p):
    """'b c (h p1) (w p2) -> b (h w) (p1 p2 c)'."""
    B, C, H, W = x.shape
    h, w = H // p, W // p
    return x.reshape(B, C, h, p, w, p).permute(0, 2, 4, 3, 5, 1).reshape(B, h * w, p * p * C)


def _unpatchify(x, p, h, w, C):
    B = x.shape[0]
    return x.reshape(B, h, w, p, p, C).permute(0, 5, 1, 3, 2, 4).reshape(B, C, h * p, w * p)


def _grid_pad(x, p):
    """Pad the last two dims up to the next multiple of ``p`` (a whole
    extra patch where they are multiples already), ``mlp.py:57-60``."""
    old_w, old_h = x.shape[-2:]
    x = F.pad(x, (0, (old_h // p) * p + p - old_h, 0, (old_w // p) * p + p - old_w))
    return x, old_w, old_h


class _MixerFF(nn.Module):
    """Linear, exact GELU, Dropout, Linear, Dropout."""

    def __init__(self, dim_in: int, dim_hidden: int, dropout: float = 0.0):
        super().__init__()
        self.fc1 = Linear(dim_in, dim_hidden)
        self.act = GELU()
        self.fc2 = Linear(dim_hidden, dim_in)
        self.drop = Dropout(dropout)

    def forward(self, x):
        return self.drop(self.fc2(self.drop(self.act(self.fc1(x)))))


class MLP(nn.Module):
    """MLP-Mixer over TF patches (legacy layer_type ``MLP``): token mixing
    over the patches, channel mixing over ``dim``, ``depth`` times."""

    def __init__(self, in_chan: int, image_size: Sequence[int], patch_size: int,
                 dim: int = 64, depth: int = 2, expansion_factor: int = 4,
                 expansion_factor_token: float = 0.5, dropout: float = 0.0):
        super().__init__()
        p = self.patch_size = patch_size
        self.depth, self.in_chan = depth, in_chan
        T, F_ = image_size
        patches = (T // p + 1) * (F_ // p + 1)
        self.embed = Linear(p * p * in_chan, dim)
        for d in range(depth):
            self.add_module(f"norm_tok{d}", LayerNorm(dim))
            self.add_module(f"tok{d}", _MixerFF(patches, patches * expansion_factor, dropout))
            self.add_module(f"norm_ch{d}", LayerNorm(dim))
            self.add_module(f"ch{d}", _MixerFF(dim, int(dim * expansion_factor_token), dropout))
        self.norm_out = LayerNorm(dim)
        self.unembed = Linear(dim, p * p * in_chan)

    def forward(self, x):
        p = self.patch_size
        x, old_w, old_h = _grid_pad(x, p)
        h, w = x.shape[2] // p, x.shape[3] // p
        y = self.embed(_patchify(x, p))
        for d in range(self.depth):
            z = getattr(self, f"tok{d}")(getattr(self, f"norm_tok{d}")(y).transpose(1, 2))
            y = z.transpose(1, 2) + y
            y = getattr(self, f"ch{d}")(getattr(self, f"norm_ch{d}")(y)) + y
        y = self.unembed(self.norm_out(y))
        return _unpatchify(y, p, h, w, self.in_chan)[..., :old_w, :old_h]


class Permutator(nn.Module):
    """ViP axis-permutation MLP (legacy layer_type ``Permutator``): per
    layer, height, width and channel mixing of ``segments`` channel groups,
    summed and projected, then a channel FF."""

    def __init__(self, in_chan: int, image_size: Sequence[int], patch_size: int,
                 dim: int = 64, depth: int = 2, segments: int = 4, expansion_factor: int = 4,
                 dropout: float = 0.0):
        super().__init__()
        assert dim % segments == 0
        p = self.patch_size = patch_size
        self.depth, self.in_chan, self.segments, self.dim = depth, in_chan, segments, dim
        T, F_ = image_size
        h, w = T // p + 1, F_ // p + 1
        self.embed = Linear(p * p * in_chan, dim)
        for d in range(depth):
            self.add_module(f"norm_perm{d}", LayerNorm(dim))
            self.add_module(f"hmix{d}", Linear(h * segments, h * segments))
            self.add_module(f"wmix{d}", Linear(w * segments, w * segments))
            self.add_module(f"cmix{d}", Linear(dim, dim))
            self.add_module(f"proj{d}", Linear(dim, dim))
            self.add_module(f"norm_ff{d}", LayerNorm(dim))
            self.add_module(f"ff{d}", _MixerFF(dim, dim * expansion_factor, dropout))
        self.norm_out = LayerNorm(dim)
        self.unembed = Linear(dim, p * p * in_chan)

    def forward(self, x):
        p, s = self.patch_size, self.segments
        x, old_w, old_h = _grid_pad(x, p)
        B, C, H, W = x.shape
        h, w, c = H // p, W // p, self.dim // s
        y = self.embed(_patchify(x, p).reshape(B, h, w, p * p * C))
        for d in range(self.depth):
            z = getattr(self, f"norm_perm{d}")(y)
            zs = z.reshape(B, h, w, c, s)
            # height mixing 'b h w (c s) -> b w c (h s)', width 'b h w (c s) -> b h c (w s)'
            zh = getattr(self, f"hmix{d}")(zs.permute(0, 2, 3, 1, 4).reshape(B, w, c, h * s))
            zh = zh.reshape(B, w, c, h, s).permute(0, 3, 1, 2, 4).reshape(B, h, w, c * s)
            zw = getattr(self, f"wmix{d}")(zs.permute(0, 1, 3, 2, 4).reshape(B, h, c, w * s))
            zw = zw.reshape(B, h, c, w, s).permute(0, 1, 3, 2, 4).reshape(B, h, w, c * s)
            y = getattr(self, f"proj{d}")(zh + zw + getattr(self, f"cmix{d}")(z)) + y
            y = getattr(self, f"ff{d}")(getattr(self, f"norm_ff{d}")(y)) + y
        y = self.unembed(self.norm_out(y))
        return _unpatchify(y.reshape(B, h * w, p * p * C), p, h, w, C)[..., :old_w, :old_h]
