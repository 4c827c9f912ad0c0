"""Recurrent blocks (reference ``src/models/layers/rnn_layers.py``).

DualPathRNN is the RTFS core: k-sample windows along one TF axis, a
(bi)RNN over the window sequence with the other axis folded into the
batch, and a ConvTranspose overlap-add back to C channels with a residual.
Its recurrence is an SRU (the kernels of ``ops/rnn.py``), an LSTM or GRU
(PyTorch's recurrence) or self-attention over the windows (``Attn``).
"""
from __future__ import annotations

import math
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...ops import activations
from ...ops.conv import ConvTranspose, Linear, unfold_1d
from ...ops.dropout import Dropout
from ...ops.normalizations import LayerNorm
from ...ops.rnn import GRU, LSTM, get_rnn
from ...utils.profiling import span
from .attention_blocks import MultiHeadSelfAttention
from .conv_blocks import ConvActNorm, FeedForwardNetwork, make_norm


class RNNProjection(nn.Module):
    """LayerNorm -> one-layer (bi)LSTM/GRU -> PReLU, Dropout, Linear,
    Dropout (``proj``) -> LayerNorm over the sum with the first norm's
    output, plus the input (``rnn_layers.py:12-59``); on (B, C, L)."""

    def __init__(self, input_size: int, hidden_size: int, rnn_type: str = "LSTM",
                 dropout: float = 0.0, bidirectional: bool = True):
        super().__init__()
        num_dir = 2 if bidirectional else 1
        self.norm1 = LayerNorm(input_size)
        self.rnn = {"LSTM": LSTM, "GRU": GRU}[rnn_type](
            input_size, hidden_size, 1, bidirectional, batch_first=True)
        self.proj = nn.Sequential(activations.PReLU(), Dropout(dropout),
                                  Linear(hidden_size * num_dir, input_size), Dropout(dropout))
        self.norm2 = LayerNorm(input_size)

    def forward(self, x):
        y = self.norm1(x.transpose(1, 2))
        y = self.norm2(self.proj(self.rnn(y)) + y)
        return y.transpose(1, 2) + x


class DualPathRNN(nn.Module):
    """``dim=4`` runs the recurrence along F, ``dim=3`` along T. Both axes
    are padded up to the unfold grid. The SRU, LSTM and GRU take the
    pre-unfold sequence (``window=(k, s)``); the SRU never builds the
    windows. ``Attn`` attends over the (L, B·F, C·k) windows with the
    positional encoding indexed by dim 1 (a reference quirk, kept), and
    ``apply_ffn`` adds a FeedForwardNetwork on C·k channels after it."""

    def __init__(self, in_chan: int, hid_chan: int, dim: int, kernel_size: int = 8,
                 stride: int = 1, rnn_type: str = "LSTM", num_layers: int = 1,
                 norm_type: Any = "LayerNormalization4D", bidirectional: bool = True,
                 apply_ffn: bool = False):
        super().__init__()
        self.dim, self.kernel_size, self.stride = dim, kernel_size, stride
        self.attn = rnn_type == "Attn"
        unfolded = in_chan * kernel_size
        self.norm = make_norm(norm_type, in_chan, 1)
        if self.attn:
            self.rnn = MultiHeadSelfAttention(unfolded, 8, batch_first=False)
            rnn_out = unfolded
        else:
            self.rnn = get_rnn(rnn_type)(unfolded, hid_chan, num_layers, bidirectional)
            rnn_out = hid_chan * (2 if bidirectional else 1)
        self.ffn = (FeedForwardNetwork(unfolded, unfolded * 2, kernel_size, dropout=0.1)
                    if apply_ffn else None)
        self.linear = ConvTranspose(rnn_out, in_chan, kernel_size, ndim=1, stride=stride)

    def forward(self, x):
        with span("rtfs.refine.rnn"):
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
            if self.attn:
                y = self.rnn(unfold_1d(y, k, s).permute(2, 0, 1))
            else:
                y = self.rnn(y, window=(k, s))     # (L, B·F, O)
            y = y.permute(1, 2, 0)                  # (B·F, O, L)
            if self.ffn is not None:
                y = self.ffn(y)
            y = self.linear(y)                      # (B·F, C, new_T)
            y = y.reshape(B, new_F, C, new_T).permute(0, 2, 3, 1)
            y = (y + residual)[..., :old_T, :old_F]
            if self.dim == 4:
                y = y.transpose(-2, -1)
            return y


class ConvLSTMCell(nn.Module):
    """A conv-gated LSTM cell (``rnn_layers.py:165-228``): the input gates
    are a depthwise then a pointwise ConvActNorm (``linear_ih``), the
    hidden gates a pointwise one (``linear_hh``); with two directions each
    half of the channels has its own (``linear_ih_b``, ``linear_hh_b``)."""

    def __init__(self, in_chan: int, hid_chan: int, kernel_size: int = 1,
                 num_directions: int = 1):
        super().__init__()

        def ih():
            return nn.Sequential(
                ConvActNorm(in_chan, in_chan, kernel_size, groups=in_chan),
                ConvActNorm(in_chan, 4 * hid_chan, 1))

        self.linear_ih = ih()
        self.linear_hh = ConvActNorm(hid_chan, 4 * hid_chan, 1)
        self.bidirectional = num_directions > 1
        if self.bidirectional:
            self.linear_ih_b = ih()
            self.linear_hh_b = ConvActNorm(hid_chan, 4 * hid_chan, 1)

    def forward(self, inputs, hidden_t, cell_t):
        bs = inputs.shape[0]
        if self.bidirectional:
            in_f, in_b = inputs.chunk(2, dim=1)
            h_f, h_b = hidden_t.chunk(2, dim=1)
            gates = torch.cat([self.linear_ih(in_f) + self.linear_hh(h_f)[:bs],
                               self.linear_ih_b(in_b) + self.linear_hh_b(h_b)[:bs]], 1)
        else:
            gates = self.linear_ih(inputs) + self.linear_hh(hidden_t)[:bs]
        i, f, g, o = gates.chunk(4, dim=1)
        c_next = torch.sigmoid(f) * cell_t[:bs] + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(c_next), c_next


class BiLSTM2D(nn.Module):
    """A conv-gated LSTM over slices of ``window`` columns
    (``rnn_layers.py:231-301``): each slice is unfolded into windows and
    fed to one ConvLSTMCell whose state carries from slice to slice; two
    directions are the input and its flip, concatenated on channels. A
    grouped ConvTranspose, act, norm and a 1x1 conv project back, with a
    residual."""

    def __init__(self, in_chan: int, hid_chan: int, dim: int = 3, kernel_size: int = 5,
                 window: int = 8, stride: int = 1, act_type: Any = "PReLU",
                 norm_type: Any = "gLN", bidirectional: bool = True):
        super().__init__()
        self.dim, self.window, self.stride = dim, window, stride
        self.in_chan, self.hid_chan = in_chan, hid_chan
        self.num_dir = 2 if bidirectional else 1
        hd = hid_chan * self.num_dir
        self.norm = make_norm(norm_type, in_chan)
        self.lstm_cell = ConvLSTMCell(in_chan * window, hid_chan, kernel_size, self.num_dir)
        self.proj_deconv = ConvTranspose(hd, hd, (window, 1), ndim=2, stride=(stride, 1),
                                         groups=hd)
        self.proj_act = activations.get(act_type)()
        self.proj_norm = make_norm(norm_type, hd)
        self.proj_out = ConvActNorm(hd, in_chan, 1, is2d=True)

    def forward(self, x):
        y = self.norm(x)
        if self.num_dir > 1:
            y = torch.cat([y, y.flip(self.dim - 1)], dim=1)
        if self.dim == 3:
            y = y.transpose(-1, -2)
        bs = y.shape[0]
        old_w, old_h = y.shape[-2:]
        w_, s_ = self.window, self.stride
        new_w = int(math.ceil((old_w - w_) / s_) * s_ + w_)
        new_h = int(math.ceil((old_h - w_) / s_) * s_ + w_)
        y = F.pad(y, (0, new_h - old_h, 0, new_w - old_w))
        hd, cin = self.hid_chan * self.num_dir, self.in_chan * self.num_dir
        hidden = y.new_zeros((1, hd, 1))
        cell = y.new_zeros((1, hd, 1))
        outputs = []
        for i in range(int(math.ceil(new_h / w_))):
            sl = y[..., i * w_:(i + 1) * w_]
            wdim, hdim = sl.shape[-2:]
            sl = unfold_1d(sl.permute(0, 3, 1, 2).reshape(bs * hdim, cin, wdim), w_, s_)
            hidden, cell = self.lstm_cell(sl, hidden, cell)
            outputs.append(hidden.reshape(bs, hdim, hd, -1).permute(0, 2, 3, 1))
        y = self.proj_norm(self.proj_act(self.proj_deconv(torch.cat(outputs, dim=-1))))
        y = self.proj_out(y)[..., :old_w, :old_h]
        if self.dim == 3:
            y = y.transpose(-1, -2)
        return y + x


class GlobalAttentionRNN(nn.Module):
    """An RNNProjection (``rnn_layers.py:304-326``) on (B, C, L)."""

    def __init__(self, in_chan: int, hid_chan: Optional[int] = None, dropout: float = 0.1,
                 rnn_type: str = "LSTM", bidirectional: bool = True):
        super().__init__()
        hid = hid_chan if hid_chan is not None else in_chan
        self.RNN = RNNProjection(in_chan, hid, rnn_type, dropout, bidirectional)

    def forward(self, x):
        return self.RNN(x)


class GlobalGALR(nn.Module):
    """GALR-style (``rnn_layers.py:329-379``) on (B, C, T, F): an
    RNNProjection along T (F folded into the batch), then MHSA and an FFN
    along F (T folded in), then optionally a 2-D FFN."""

    def __init__(self, in_chan: int, hid_chan: Optional[int] = None,
                 ffn_name: str = "FeedForwardNetwork", kernel_size: int = 5, n_head: int = 8,
                 dropout: float = 0.1, group_ffn: bool = False, pos_enc: bool = True,
                 rnn_type: str = "LSTM", bidirectional: bool = True):
        super().__init__()
        from . import get_ffn

        hid = hid_chan if hid_chan is not None else 2 * in_chan
        self.time_RNN = RNNProjection(in_chan, in_chan, rnn_type, dropout, bidirectional)
        self.freq_MHSA = MultiHeadSelfAttention(in_chan, n_head, dropout, pos_enc)
        self.freq_FFN = get_ffn(ffn_name)(in_chan, hid, kernel_size, dropout=dropout)
        self.group_FFN = (FeedForwardNetwork(in_chan, hid, kernel_size, dropout=dropout,
                                             is2d=True) if group_ffn else None)

    def forward(self, x):
        B, C, T, F_ = x.shape
        y = self.time_RNN(x.permute(0, 3, 1, 2).reshape(B * F_, C, T))
        y = y.reshape(B, F_, C, T).permute(0, 3, 2, 1)           # (B, T, C, F)
        z = self.freq_FFN(self.freq_MHSA(y.reshape(B * T, C, F_)))
        z = z.reshape(B, T, C, F_).transpose(1, 2)
        return self.group_FFN(z) if self.group_FFN is not None else z
