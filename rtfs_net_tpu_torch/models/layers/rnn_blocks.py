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
from ...ops.kernels.dual_path import dual_path_norm_in, dual_path_out, dual_path_windows_in
from ...ops.normalizations import LayerNorm, LayerNormalization4D
from ...ops.rnn import GRU, LSTM, SRU, _LibraryRNN, get_rnn
from ...utils.profiling import span
from .attention_blocks import MultiHeadSelfAttention
from .conv_blocks import ConvActNorm, FeedForwardNetwork, make_norm

# DualPathRNN calls that took the sequence-layout route since the last reset
# (set it to 0 to reset)
seq_layout_calls = 0
# DualPathRNN calls that took the window-layout route since the last reset
# (set it to 0 to reset)
window_layout_calls = 0
# DualPathRNN calls that ran an LSTM or GRU through PyTorch's recurrence, on
# the window-layout route or the general one, since the last reset (set it
# to 0 to reset)
library_route_calls = 0


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
    are padded up to the unfold grid. The SRU takes the pre-unfold
    sequence (``window=(k, s)``) and never builds the windows; the LSTM,
    GRU and ``Attn`` take the unfolded (L, B·F, C·k) windows. An LSTM or GRU
    runs PyTorch's recurrence (``ops/rnn.py``: cuDNN on the card, bfloat16
    included, which copies a permuted, strided input such as this route's
    windows into a contiguous buffer first) inside the span
    ``rtfs.refine.rnn.recurrence`` and counts its call in
    ``library_route_calls``. ``Attn`` attends over the windows
    with the positional encoding indexed by dim 1 (a reference quirk,
    kept), and ``apply_ffn`` adds a FeedForwardNetwork on C·k channels
    after it.

    An SRU DualPathRNN on the ``"scan"`` route at stride 1 with a
    LayerNormalization4D over C runs, when autograd is not recording, in
    K1's (S, C, rows) layout from the norm to the residual (S the recurrent
    axis, rows the other axis times B, b-major): one kernel normalises x
    into that layout (``ops/kernels/dual_path.py``), ``SRU.forward_windows``
    projects its overlapping windows with one batched matmul and runs the
    layers, the last writing into the middle of a zero-padded buffer, the
    transposed conv is one batched matmul over that buffer's overlapping
    windows with the taps reversed, and a second kernel adds the bias and
    the residual on the way back to (B, C, T, F). Stride 1 pads nothing, so
    x itself is the residual.

    An LSTM or GRU DualPathRNN at stride 1 with no FFN and a
    LayerNormalization4D over C takes, when autograd is not recording, the
    window-layout route: one kernel normalises x straight into the
    contiguous (L, rows, C·k) windows cuDNN reads
    (``ops/kernels/dual_path.py:dual_path_windows_in``), so neither the
    unfold nor cuDNN copies them, and the recurrence and the general route's
    exit follow as they are, with x as the residual. Every other call,
    training among them, takes the general route."""

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

    def _layout_route(self, x) -> bool:
        """What both layout routes need: stride 1 (the unfold pads nothing),
        no FFN, a LayerNormalization4D over C, a dtype the kernels take and
        autograd not recording."""
        return (self.stride == 1 and self.ffn is None
                and isinstance(self.norm, LayerNormalization4D) and self.norm.dims == (1,)
                and x.dtype in (torch.float32, torch.bfloat16)
                and not (torch.is_grad_enabled()
                         and (x.requires_grad or any(p.requires_grad for p in self.parameters()))))

    def takes_seq_layout(self, x) -> bool:
        """Whether this call of ``forward`` takes the sequence-layout route."""
        return isinstance(self.rnn, SRU) and self.rnn.route() == "scan" and self._layout_route(x)

    def takes_window_layout(self, x) -> bool:
        """Whether this call of ``forward`` takes the window-layout route."""
        return isinstance(self.rnn, _LibraryRNN) and self._layout_route(x)

    def _forward_seq_layout(self, x):
        global seq_layout_calls
        seq_dim, k = self.dim - 1, self.kernel_size
        x = x.contiguous()
        C = x.shape[1]
        y = dual_path_norm_in(x, self.norm.gamma.view(C).float(),
                              self.norm.beta.view(C).float(), seq_dim=seq_dim,
                              eps=self.norm.eps)                      # (S, C, rows)
        S, _, rows = y.shape
        h = self.rnn.forward_windows(y, k, pad=k - 1)               # (L + 2(k-1), O, rows)
        O = h.shape[1]
        # ConvTranspose1d at stride 1: out[s] = sum over taps j of w[:, :, j]^T h[s - j],
        # i.e. the window h_padded[s:s + k] against the taps reversed, columns j'*O + o
        w = self.linear.weight.permute(1, 2, 0).flip(1).reshape(C, k * O).to(x.dtype)
        z = torch.matmul(w, h.as_strided((S, k * O, rows), (O * rows, rows, 1)))
        seq_layout_calls += 1
        return dual_path_out(z, self.linear.bias.float(), x, seq_dim=seq_dim)

    def _forward_window_layout(self, x):
        global window_layout_calls
        if x.shape[3] > 1 and x.stride(3) != 1:
            x = x.contiguous()
        C = x.shape[1]
        y = dual_path_windows_in(x, self.norm.gamma.view(C).float(),
                                 self.norm.beta.view(C).float(), seq_dim=self.dim - 1,
                                 k=self.kernel_size, eps=self.norm.eps)   # (L, B·F, C·k)
        window_layout_calls += 1
        y = self._library_recurrence(y)
        if self.dim == 4:
            x = x.transpose(-2, -1)
        return self._exit(y, x, *x.shape[2:])

    def _library_recurrence(self, y):
        """The LSTM or GRU over the (L, B·F, C·k) windows, PyTorch's own
        recurrence, inside its span; the span holds besides only the
        per-call weight casts, the zero initial state and, on the card for
        the general route's strided windows, cuDNN's contiguous copy of
        them."""
        global library_route_calls
        library_route_calls += 1
        with span("rtfs.refine.rnn.recurrence"):
            return self.rnn(y)

    def _exit(self, y, residual, old_T, old_F):
        """The general route's exit: the recurrence's (L, B·F, O) output
        through the FFN, if any, and the ConvTranspose1d overlap-add back to
        (B, C, T, F) (T the recurrent axis, as ``residual`` has it), plus
        the residual, cut to (old_T, old_F)."""
        B, C, new_T, new_F = residual.shape
        y = y.permute(1, 2, 0)                  # (B·F, O, L)
        if self.ffn is not None:
            y = self.ffn(y)
        y = self.linear(y)                      # (B·F, C, new_T)
        y = y.reshape(B, new_F, C, new_T).permute(0, 2, 3, 1)
        y = (y + residual)[..., :old_T, :old_F]
        if self.dim == 4:
            y = y.transpose(-2, -1)
        return y

    def forward(self, x):
        with span("rtfs.refine.rnn"):
            if self.takes_seq_layout(x):
                return self._forward_seq_layout(x)
            if self.takes_window_layout(x):
                return self._forward_window_layout(x)
            if self.dim == 4:
                x = x.transpose(-2, -1)
            B, C, old_T, old_F = x.shape
            k, s = self.kernel_size, self.stride
            new_T = int(math.ceil((old_T - k) / s) * s + k)
            new_F = int(math.ceil((old_F - k) / s) * s + k)
            x = F.pad(x, (0, new_F - old_F, 0, new_T - old_T))
            y = self.norm(x)
            y = y.permute(0, 3, 1, 2).reshape(B * new_F, C, new_T)
            if isinstance(self.rnn, SRU):
                y = self.rnn(y, window=(k, s))     # (L, B·F, O)
            else:
                y = unfold_1d(y, k, s).permute(2, 0, 1)    # (L, B·F, C·k)
                y = self.rnn(y) if self.attn else self._library_recurrence(y)
            return self._exit(y, x, old_T, old_F)


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
