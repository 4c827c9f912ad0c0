"""Fusion cells (reference ``src/models/layers/fusion.py``):
InjectionMultiSum, the TF-AR reconstruction unit at every TDANet scale,
and ATTNFusionCell, the CAF cross-modal block of the RTFS-Net configs."""
from __future__ import annotations

import math
from typing import Any

import torch
from torch import nn

from ...ops.conv import interpolate_nearest
from .conv_blocks import ConvNormAct


def _spatial_shape(x):
    """Trailing spatial dims by the reference's rule ``shape[-(ndim//2):]``."""
    return tuple(x.shape[-(x.dim() // 2):])


class InjectionMultiSum(nn.Module):
    """local_emb * sigmoid_gate(global) + global_emb, interpolating the
    smaller side (``fusion.py:9-69``)."""

    def __init__(self, in_chan: int, kernel_size: int, norm_type: Any = "gLN",
                 is2d: bool = False):
        super().__init__()

        def dw(act=None):
            return ConvNormAct(in_chan, in_chan, kernel_size, groups=in_chan,
                               norm_type=norm_type, act_type=act, bias=False, is2d=is2d)

        self.local_embedding = dw()
        self.global_embedding = dw()
        self.global_gate = dw("Sigmoid")

    def forward(self, local_features, global_features):
        new_shape = _spatial_shape(local_features)
        local_emb = self.local_embedding(local_features)
        if math.prod(new_shape) > math.prod(_spatial_shape(global_features)):
            global_emb = interpolate_nearest(self.global_embedding(global_features), new_shape)
            gate = interpolate_nearest(self.global_gate(global_features), new_shape)
        else:
            g = interpolate_nearest(global_features, new_shape)
            global_emb = self.global_embedding(g)
            gate = self.global_gate(g)
        return local_emb * gate + global_emb


class ATTNFusionCell(nn.Module):
    """CAF block (``fusion.py:194-274``): modality b gives a resize gate on
    a's keys and softmax attention weights (mean over kernel taps, softmax
    over b's time, nearest-interpolated to a's time) on a's values;
    output k1 + k2. With ``is2d`` a is (B, C, T, F) and b's (B, C, T)
    streams broadcast over F."""

    def __init__(self, in_chan_a: int, in_chan_b: int, kernel_size: int = 1,
                 is2d: bool = False):
        super().__init__()
        self.in_chan_a, self.kernel_size, self.is2d = in_chan_a, kernel_size, is2d
        bn = "BatchNorm2d" if is2d else "BatchNorm1d"
        self.key_embed = ConvNormAct(in_chan_a, in_chan_a, 1, groups=in_chan_a,
                                     norm_type=bn, act_type="ReLU", bias=False, is2d=is2d)
        self.value_embed = ConvNormAct(in_chan_a, in_chan_a, 1, groups=in_chan_a,
                                       norm_type=bn, bias=False, is2d=is2d)
        self.attention_embed = ConvNormAct(in_chan_b, kernel_size * in_chan_a, 1,
                                           groups=in_chan_a, norm_type="gLN")
        self.resize = ConvNormAct(in_chan_b, in_chan_a, 1, groups=in_chan_a,
                                  norm_type="gLN")

    def forward(self, tensor_a, tensor_b):
        B, time_steps = tensor_a.shape[0], tensor_a.shape[2]

        def to_a(t):  # (B, C, T_b) -> a's time, broadcast over a's F
            t = interpolate_nearest(t, (time_steps,))
            return t[..., None] if self.is2d else t

        k1 = self.key_embed(tensor_a) * to_a(self.resize(tensor_b))
        att = self.attention_embed(tensor_b)
        att = att.reshape(B, self.in_chan_a, self.kernel_size, -1).mean(2)
        k2 = to_a(torch.softmax(att, dim=-1)) * self.value_embed(tensor_a)
        return k1 + k2
