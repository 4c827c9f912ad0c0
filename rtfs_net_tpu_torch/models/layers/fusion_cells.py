"""Fusion cells (reference ``src/models/layers/fusion.py``):
InjectionMultiSum, the TF-AR reconstruction unit at every TDANet scale;
the LSTM- and GRU-gate cross-modal cells; and ATTNFusionCell, the CAF
cross-modal block of the RTFS-Net configs."""
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


def _bidirectional(x, is2d: bool):
    """x concatenated along channels with itself flipped in time (and
    frequency, with ``is2d``)."""
    return torch.cat([x, torch.flip(x, (-2, -1) if is2d else (-1,))], dim=1)


class _GatedFusionCell(nn.Module):
    """Convs ``conv_a`` on modality a and ``conv_b`` on modality b to
    ``gates`` x in_chan_a channels (gLN, ``groups`` groups), b resized to
    a's shape before its conv or after it, whichever side is smaller."""

    def __init__(self, in_chan_a: int, in_chan_b: int, kernel_size: int, bidirectional: bool,
                 is2d: bool, gates: int, groups: int):
        super().__init__()
        self.bidirectional, self.is2d = bidirectional, is2d
        num_dir = 2 if bidirectional else 1
        self.conv_a = ConvNormAct(in_chan_a * num_dir, in_chan_a * gates, kernel_size,
                                  is2d=is2d, groups=groups, norm_type="gLN")
        self.conv_b = ConvNormAct(in_chan_b * num_dir, in_chan_a * gates, kernel_size,
                                  is2d=is2d, groups=groups, norm_type="gLN")

    def gates(self, tensor_a, tensor_b):
        """(conv_a(a), conv_b(b) at a's shape)."""
        if self.bidirectional:
            tensor_a = _bidirectional(tensor_a, self.is2d)
            tensor_b = _bidirectional(tensor_b, self.is2d)
        new_shape = _spatial_shape(tensor_a)
        old_shape = _spatial_shape(tensor_b)[-len(new_shape):]
        if math.prod(new_shape) > math.prod(old_shape):
            hb = interpolate_nearest(self.conv_b(tensor_b), new_shape)
        else:
            hb = self.conv_b(interpolate_nearest(tensor_b, new_shape))
        return self.conv_a(tensor_a), hb


class ConvLSTMFusionCell(_GatedFusionCell):
    """LSTM-gate cross-modal fusion (``fusion.py:72-124``): i, f, g, o from
    conv_a(a) + conv_b(b); c = sigmoid(f) + sigmoid(i)·tanh(g), out
    sigmoid(o)·tanh(c). Convs in in_chan_a // 4 groups."""

    def __init__(self, in_chan_a: int, in_chan_b: int, kernel_size: int = 1,
                 bidirectional: bool = False, is2d: bool = False):
        super().__init__(in_chan_a, in_chan_b, kernel_size, bidirectional, is2d, 4,
                         in_chan_a // 4)

    def forward(self, tensor_a, tensor_b):
        ha, hb = self.gates(tensor_a, tensor_b)
        i_t, f_t, g_t, o_t = torch.chunk(ha + hb, 4, dim=1)
        c_next = torch.sigmoid(f_t) + torch.sigmoid(i_t) * torch.tanh(g_t)
        return torch.sigmoid(o_t) * torch.tanh(c_next)


class ConvGRUFusionCell(_GatedFusionCell):
    """GRU-gate cross-modal fusion (``fusion.py:127-191``): r, z, n from
    conv_a(a) and conv_b(b); out (1 - z)·tanh(x_n + r·h_n). Convs in
    in_chan_a groups."""

    def __init__(self, in_chan_a: int, in_chan_b: int, kernel_size: int = 1,
                 bidirectional: bool = False, is2d: bool = False):
        super().__init__(in_chan_a, in_chan_b, kernel_size, bidirectional, is2d, 3,
                         in_chan_a)

    def forward(self, tensor_a, tensor_b):
        xg, hg = self.gates(tensor_a, tensor_b)
        x_r, x_z, x_n = torch.chunk(xg, 3, dim=1)
        h_r, h_z, h_n = torch.chunk(hg, 3, dim=1)
        r_t = torch.sigmoid(x_r + h_r)
        z_t = torch.sigmoid(x_z + h_z)
        return (1.0 - z_t) * torch.tanh(x_n + r_t * h_n)


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
