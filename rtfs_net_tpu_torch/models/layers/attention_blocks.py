"""Attention blocks (reference ``src/models/layers/attention.py``).

Sequences are short (T <= 251 after the STFT hop), so attention is a
plain matmul -> softmax -> matmul. In training mode dropout acts where the
JAX package has it: on the attention weights, on the MHA output, and as
DropPath on the MHSA residual (``ops/dropout.py`` draws the masks).
"""
from __future__ import annotations

import functools
import math
from typing import Any, Optional

import numpy as np
import torch
from torch import nn

from ...ops.conv import DropPath, Linear
from ...ops.dropout import dropout
from ...ops.normalizations import LayerNorm
from .conv_blocks import ConvActNorm, FeedForwardNetwork


@functools.lru_cache(maxsize=16)
def positional_encoding(length: int, channels: int, max_len: int = 10000) -> np.ndarray:
    """Sinusoidal PE (reference ``attention.py:9-25``; its div_term uses
    log(max_len), replicated)."""
    position = np.arange(max_len)[:, None].astype(np.float32)
    div_term = np.exp(
        np.arange(0, channels, 2).astype(np.float32) * -(math.log(float(max_len)) / channels))
    pe = np.zeros((max_len, channels), np.float32)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe[:length]


class MultiheadAttention(nn.Module):
    """torch ``nn.MultiheadAttention`` parameters and math (packed qkv
    ``in_proj``, ``out_proj``), written out as matmuls."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 batch_first: bool = True):
        super().__init__()
        self.num_heads, self.batch_first, self.dropout = num_heads, batch_first, dropout
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = Linear(embed_dim, embed_dim)
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        # torch: xavier-uniform in_proj weight, zero in_proj bias
        E3, E = self.in_proj_weight.shape
        bound = math.sqrt(6.0 / (E3 + E))
        with torch.no_grad():
            self.in_proj_weight.uniform_(-bound, bound, generator=generator)
            self.in_proj_bias.zero_()

    def forward(self, x):
        seq = x if self.batch_first else x.transpose(0, 1)  # (B, L, E)
        B, L, E = seq.shape
        nh = self.num_heads
        hd = E // nh
        qkv = torch.nn.functional.linear(seq, self.in_proj_weight.to(seq.dtype),
                                         self.in_proj_bias.to(seq.dtype))
        q, k, v = (t.reshape(B, L, nh, hd).transpose(1, 2) for t in qkv.chunk(3, -1))
        attn = torch.softmax(q @ k.transpose(-2, -1) / math.sqrt(hd), dim=-1)
        attn = dropout(attn, self.dropout, self.training)
        out = self.out_proj((attn @ v).transpose(1, 2).reshape(B, L, E))
        return out if self.batch_first else out.transpose(0, 1)


class MultiHeadSelfAttention(nn.Module):
    """LN -> PE -> MHA -> residual -> LN -> residual on (B, C, T), or on
    (L, B, C) when not ``batch_first`` (``attention.py:28-73``). The PE is
    indexed by dim 1 whatever the layout (a reference quirk, kept)."""

    def __init__(self, in_chan: int, n_head: int = 8, dropout: float = 0.1,
                 positional_encoding: bool = True, batch_first: bool = True):
        super().__init__()
        self.batch_first, self.pos_enc, self.dropout = batch_first, positional_encoding, dropout
        self.norm1 = LayerNorm(in_chan)
        self.attention = MultiheadAttention(in_chan, n_head, dropout, batch_first)
        self.norm2 = LayerNorm(in_chan)
        self.drop_path = DropPath(dropout)

    def forward(self, x):
        y = x.transpose(1, 2) if self.batch_first else x
        y = self.norm1(y)
        if self.pos_enc:
            pe = positional_encoding(y.shape[1], y.shape[2])
            y = y + torch.from_numpy(pe).to(device=y.device, dtype=y.dtype)
        y = self.norm2(dropout(self.attention(y), self.dropout, self.training,
                               0 if self.batch_first else 1) + y)
        if self.batch_first:
            y = y.transpose(1, 2)
        return self.drop_path(y) + x


class MultiHeadSelfAttention2D(nn.Module):
    """RTFS TF-attention over (B, C, T, F) (``attention.py:76-189``):
    per-head 1x1 ConvActNorm Queries/Keys/Values, attention over T with
    (E·F)-dim keys, heads folded into the batch (row ``h*B + b``). ``dim=4``
    transposes T and F so the block attends over frequency."""

    def __init__(self, in_chan: int, n_freqs: int, n_head: int = 4, hid_chan: int = 4,
                 act_type: Any = "PReLU", norm_type: Any = "LayerNormalization4D",
                 dim: int = 3):
        super().__init__()
        self.n_head, self.dim = n_head, dim

        def heads(out_chan):
            return nn.ModuleList(
                ConvActNorm(in_chan, out_chan, 1, act_type=act_type, norm_type=norm_type,
                            n_freqs=n_freqs, is2d=True) for _ in range(n_head))

        self.Queries = heads(hid_chan)
        self.Keys = heads(hid_chan)
        self.Values = heads(in_chan // n_head)
        self.attn_concat_proj = ConvActNorm(in_chan, in_chan, 1, act_type=act_type,
                                            norm_type=norm_type, n_freqs=n_freqs,
                                            is2d=True)

    def forward(self, x):
        if self.dim == 4:
            x = x.transpose(-2, -1)
        B, C, T, F = x.shape
        q = torch.cat([m(x) for m in self.Queries], 0)  # (H·B, E, T, F)
        k = torch.cat([m(x) for m in self.Keys], 0)
        v = torch.cat([m(x) for m in self.Values], 0)   # (H·B, C/H, T, F)
        q = q.transpose(1, 2).flatten(2)                # (H·B, T, E·F)
        k = k.transpose(1, 2).flatten(2)
        cv = v.shape[1]
        attn = torch.softmax(q @ k.transpose(1, 2) / math.sqrt(q.shape[-1]), dim=-1)
        out = (attn @ v.transpose(1, 2).flatten(2)).view(-1, T, cv, F).transpose(1, 2)
        out = out.reshape(self.n_head, B, cv, T, F).transpose(0, 1).reshape(B, C, T, F)
        out = self.attn_concat_proj(out) + x
        if self.dim == 4:
            out = out.transpose(-2, -1)
        return out


class GlobalAttention(nn.Module):
    """MHSA + conv-FFN on (B, C, T), the video-branch layer
    (``attention.py:192-220``)."""

    def __init__(self, in_chan: int, hid_chan: Optional[int] = None,
                 ffn_name: str = "FeedForwardNetwork", kernel_size: int = 5,
                 n_head: int = 8, dropout: float = 0.1, pos_enc: bool = True):
        super().__init__()
        if ffn_name != "FeedForwardNetwork":
            raise NotImplementedError(f"GlobalAttention ffn_name={ffn_name!r} is not ported yet")
        hid = hid_chan if hid_chan is not None else 2 * in_chan
        self.MHSA = MultiHeadSelfAttention(in_chan, n_head, dropout, pos_enc)
        self.FFN = FeedForwardNetwork(in_chan, hid, kernel_size, dropout=dropout)

    def forward(self, x):
        return self.FFN(self.MHSA(x))
