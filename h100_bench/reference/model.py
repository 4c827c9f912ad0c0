"""Plain PyTorch reference of the two benchmark models and their video
front-end: RTFS-Net (arXiv:2309.17189) and CTCNet, each an AVNet built
from its YAML config, and the FRCNN lip encoder (Conv3d stem + ResNet-18
with PReLU).

A frozen copy, written for reading rather than speed: no hand-written
kernel, no checkpointing, the SRU as its recurrence step by step. Module
and parameter names follow the published models' state dicts, so one state
dict loads into this reference and into the program alike. Every module
computes in the dtype of its input and parameters (float32 for the
reference; the controls run it lower, ``precision.py``).

Dropout draws ``torch.rand(shape, generator=...) < 1 - p`` from the
generator set by ``use_generator``, one draw per dropout call in forward
order, as the program's training step draws its masks.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import precision

EPS = 1e-5
_GEN = [None]


@contextlib.contextmanager
def use_generator(generator):
    _GEN[0] = generator
    try:
        yield
    finally:
        _GEN[0] = None


def _keep(shape, keep, device):
    return torch.rand(shape, generator=_GEN[0], device=device) < keep


def dropout(x, p, training):
    if not training or p == 0.0:
        return x
    keep = 1.0 - p
    return torch.where(_keep(x.shape, keep, x.device), x / keep, torch.zeros_like(x))


class DropPath(nn.Module):
    def __init__(self, p=0.0):
        super().__init__()
        self.p = p

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        keep = 1.0 - self.p
        mask = _keep((x.shape[0],) + (1,) * (x.dim() - 1), keep, x.device)
        return torch.where(mask, x / keep, torch.zeros_like(x))


# ---------------------------------------------------------------- primitives

def _tuple(v, n):
    return tuple(v) if isinstance(v, (list, tuple)) else (v,) * n


class Conv(nn.Module):
    """nn.Conv{1,2,3}d; ``padding="same"`` pads total//2 before and the rest
    after (torch's rule for an even kernel); weight (O, I/g, *k)."""

    def __init__(self, cin, cout, k, ndim=1, stride=1, padding=0, dilation=1, groups=1,
                 bias=True):
        super().__init__()
        self.k, self.ndim, self.groups = _tuple(k, ndim), ndim, groups
        self.stride, self.dilation = _tuple(stride, ndim), _tuple(dilation, ndim)
        if padding == "same":
            self.pads = [(d * (kk - 1) // 2, d * (kk - 1) - d * (kk - 1) // 2)
                         for kk, d in zip(self.k, self.dilation)]
        else:
            self.pads = [(p, p) for p in _tuple(padding, ndim)]
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, *self.k))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None

    def forward(self, x):
        x = F.pad(x, [p for lo_hi in reversed(self.pads) for p in lo_hi])
        conv = (F.conv1d, F.conv2d, F.conv3d)[self.ndim - 1]
        return conv(precision.q(x), precision.q(self.weight), self.bias, self.stride, 0,
                    self.dilation, self.groups)


class ConvTranspose(nn.Module):
    """nn.ConvTranspose{1,2}d; weight (I, O/g, *k)."""

    def __init__(self, cin, cout, k, ndim=1, stride=1, padding=0, output_padding=0,
                 groups=1, bias=True):
        super().__init__()
        self.ndim, self.groups = ndim, groups
        self.stride, self.padding = _tuple(stride, ndim), _tuple(padding, ndim)
        self.output_padding = _tuple(output_padding, ndim)
        self.weight = nn.Parameter(torch.empty(cin, cout // groups, *_tuple(k, ndim)))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None

    def forward(self, x):
        conv = (F.conv_transpose1d, F.conv_transpose2d)[self.ndim - 1]
        return conv(precision.q(x), precision.q(self.weight), self.bias, self.stride,
                    self.padding, self.output_padding, self.groups)


class Linear(nn.Module):
    def __init__(self, cin, cout, bias=True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None

    def forward(self, x):
        return F.linear(precision.q(x), precision.q(self.weight), self.bias)


def matmul(a, b):
    return precision.q(a) @ precision.q(b)


class PReLU(nn.Module):
    def __init__(self, n=1, init=0.25):
        super().__init__()
        self.weight = nn.Parameter(torch.full((n,), init))

    def forward(self, x):
        return F.prelu(x, self.weight)


class GlobalLayerNorm(nn.Module):
    """gLN: one group over channels and every spatial dim; key ``norm.*``."""

    def __init__(self, c):
        super().__init__()
        self.norm = nn.GroupNorm(1, c, eps=EPS)

    def forward(self, x):
        return F.group_norm(x, 1, self.norm.weight, self.norm.bias, EPS)


class LayerNormalization4D(nn.Module):
    def __init__(self, c, param_freq=1):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(1, c, 1, param_freq))
        self.beta = nn.Parameter(torch.zeros(1, c, 1, param_freq))
        self.dims = (1, 3) if param_freq > 1 else (1,)

    def forward(self, x):
        var, mean = torch.var_mean(x, dim=self.dims, correction=0, keepdim=True)
        return (x - mean) / torch.sqrt(var + EPS) * self.gamma + self.beta


class BatchNorm(nn.modules.batchnorm._BatchNorm):
    """Batch norm over dim 1 of any rank (running statistics in eval mode)."""

    def _check_input_dim(self, x):
        pass


class LayerNorm(nn.LayerNorm):
    pass


NORMS = {"gln": GlobalLayerNorm, "layernormalization4d": LayerNormalization4D,
         "batchnorm1d": BatchNorm, "batchnorm2d": BatchNorm, "batchnorm3d": BatchNorm}
ACTS = {"relu": nn.ReLU, "prelu": PReLU, "sigmoid": nn.Sigmoid, "tanh": nn.Tanh}


def make_norm(kind, c, n_freqs=-1):
    if kind is None:
        return nn.Identity()
    cls = NORMS[kind.lower()]
    if cls is LayerNormalization4D:
        return cls(c, n_freqs if n_freqs > 0 else 1)
    return cls(c)


def make_act(kind):
    return nn.Identity() if kind is None else ACTS[kind.lower()]()


def nearest(x, size):
    size = tuple(int(s) for s in size)
    return x if tuple(x.shape[2:]) == size else F.interpolate(x, size=size, mode="nearest")


def avg_pool_to(x, size):
    size = tuple(int(s) for s in size)
    if tuple(x.shape[2:]) == size:
        return x
    return (F.adaptive_avg_pool1d if x.dim() == 3 else F.adaptive_avg_pool2d)(x, size)


def unfold_1d(x, k, s=1):
    """(B, C, T) -> (B, C·k, L), rows ``c*k + tap``."""
    B, C, _ = x.shape
    return x.unfold(2, k, s).permute(0, 1, 3, 2).reshape(B, C * k, -1)


def spatial(x):
    return tuple(x.shape[-(x.dim() // 2):])


# ------------------------------------------------------------------- blocks

class ConvNormAct(nn.Module):
    """pre_norm -> pre_act -> conv -> norm -> act (``full_layer``)."""

    def __init__(self, in_chan=1, out_chan=1, kernel_size=-1, stride=1, groups=1, dilation=1,
                 pre_norm_type=None, pre_act_type=None, norm_type=None, act_type=None,
                 bias=True, is2d=False, **_):
        super().__init__()
        out_chan = out_chan if kernel_size > 0 else in_chan
        pad = dilation * (kernel_size - 1) // 2 if stride > 1 else "same"
        conv = (Conv(in_chan, out_chan, kernel_size, 2 if is2d else 1, stride, pad, dilation,
                     groups, bias) if kernel_size > 0 else nn.Identity())
        self.full_layer = nn.Sequential(make_norm(pre_norm_type, in_chan),
                                        make_act(pre_act_type), conv,
                                        make_norm(norm_type, out_chan), make_act(act_type))

    def forward(self, x):
        return self.full_layer(x)


class ConvActNorm(nn.Module):
    def __init__(self, in_chan, out_chan, kernel_size, norm_type=None, act_type=None,
                 n_freqs=-1, is2d=False):
        super().__init__()
        self.conv = Conv(in_chan, out_chan, kernel_size, 2 if is2d else 1, padding="same")
        self.act = make_act(act_type)
        self.norm = make_norm(norm_type, out_chan, n_freqs)

    def forward(self, x):
        return self.norm(self.act(self.conv(x)))


class FeedForwardNetwork(nn.Module):
    def __init__(self, in_chan, hid_chan, kernel_size=5, dropout=0.0):
        super().__init__()
        self.encoder = ConvNormAct(in_chan, hid_chan, 1, norm_type="gLN", bias=False)
        self.refiner = ConvNormAct(hid_chan, hid_chan, kernel_size, groups=hid_chan,
                                   act_type="ReLU")
        self.decoder = ConvNormAct(hid_chan, in_chan, 1, norm_type="gLN", bias=False)
        self.drop_path = DropPath(dropout)

    def forward(self, x):
        y = self.drop_path(self.refiner(self.encoder(x)))
        return self.drop_path(self.decoder(y)) + x


def positional_encoding(length, channels, max_len=10000):
    position = np.arange(max_len)[:, None].astype(np.float32)
    div_term = np.exp(np.arange(0, channels, 2).astype(np.float32)
                      * -(math.log(float(max_len)) / channels))
    pe = np.zeros((max_len, channels), np.float32)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe[:length]


class MultiheadAttention(nn.Module):
    """nn.MultiheadAttention's parameters (batch first), dropout on the
    attention weights."""

    def __init__(self, E, heads, dropout):
        super().__init__()
        self.heads, self.dropout = heads, dropout
        self.in_proj_weight = nn.Parameter(torch.empty(3 * E, E))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * E))
        self.out_proj = Linear(E, E)

    def forward(self, x):
        B, L, E = x.shape
        hd = E // self.heads
        qkv = F.linear(precision.q(x), precision.q(self.in_proj_weight), self.in_proj_bias)
        q, k, v = (t.reshape(B, L, self.heads, hd).transpose(1, 2) for t in qkv.chunk(3, -1))
        attn = torch.softmax(matmul(q, k.transpose(-2, -1)) / math.sqrt(hd), dim=-1)
        attn = dropout(attn, self.dropout, self.training)
        return self.out_proj(matmul(attn, v).transpose(1, 2).reshape(B, L, E))


class MultiHeadSelfAttention(nn.Module):
    def __init__(self, in_chan, n_head=8, dropout=0.1):
        super().__init__()
        self.dropout = dropout
        self.norm1 = LayerNorm(in_chan)
        self.attention = MultiheadAttention(in_chan, n_head, dropout)
        self.norm2 = LayerNorm(in_chan)
        self.drop_path = DropPath(dropout)

    def forward(self, x):
        y = self.norm1(x.transpose(1, 2))
        pe = positional_encoding(y.shape[1], y.shape[2])
        y = y + torch.from_numpy(pe).to(device=y.device, dtype=y.dtype)
        y = self.norm2(dropout(self.attention(y), self.dropout, self.training) + y)
        return self.drop_path(y.transpose(1, 2)) + x


class GlobalAttention(nn.Module):
    def __init__(self, in_chan, kernel_size=5, n_head=8, dropout=0.1, **_):
        super().__init__()
        self.MHSA = MultiHeadSelfAttention(in_chan, n_head, dropout)
        self.FFN = FeedForwardNetwork(in_chan, 2 * in_chan, kernel_size, dropout)

    def forward(self, x):
        return self.FFN(self.MHSA(x))


class MultiHeadSelfAttention2D(nn.Module):
    """Attention over T with (E·F)-dim keys, heads folded into the batch."""

    def __init__(self, in_chan, n_freqs, n_head=4, hid_chan=4, act_type="PReLU",
                 norm_type="LayerNormalization4D", dim=3, **_):
        super().__init__()
        self.n_head, self.dim = n_head, dim

        def heads(c):
            return nn.ModuleList(ConvActNorm(in_chan, c, 1, norm_type, act_type, n_freqs, True)
                                 for _ in range(n_head))

        self.Queries, self.Keys = heads(hid_chan), heads(hid_chan)
        self.Values = heads(in_chan // n_head)
        self.attn_concat_proj = ConvActNorm(in_chan, in_chan, 1, norm_type, act_type, n_freqs,
                                            True)

    def forward(self, x):
        if self.dim == 4:
            x = x.transpose(-2, -1)
        B, C, T, Fq = x.shape
        q = torch.cat([m(x) for m in self.Queries], 0).transpose(1, 2).flatten(2)
        k = torch.cat([m(x) for m in self.Keys], 0).transpose(1, 2).flatten(2)
        v = torch.cat([m(x) for m in self.Values], 0)
        cv = v.shape[1]
        attn = torch.softmax(matmul(q, k.transpose(1, 2)) / math.sqrt(q.shape[-1]), dim=-1)
        out = matmul(attn, v.transpose(1, 2).flatten(2)).view(-1, T, cv, Fq).transpose(1, 2)
        out = out.reshape(self.n_head, B, cv, T, Fq).transpose(0, 1).reshape(B, C, T, Fq)
        out = self.attn_concat_proj(out) + x
        return out.transpose(-2, -1) if self.dim == 4 else out


class SRUCell(nn.Module):
    """sru 2.6 v2: weight (d_in, ndir·k·H), columns [dir][chunk][h]; k = 4
    (highway chunk) when d_in != ndir·H, else 3 (the input is the highway)."""

    def __init__(self, d_in, H, ndir):
        super().__init__()
        self.H, self.ndir = H, ndir
        self.k = 4 if d_in != H * ndir else 3
        self.weight = nn.Parameter(torch.empty(d_in, ndir * self.k * H))
        self.weight_c = nn.Parameter(torch.empty(2 * H * ndir))
        self.bias = nn.Parameter(torch.empty(2 * H * ndir))

    def forward(self, x):
        """x (L, rows, d_in) -> (L, rows, ndir·H): the recurrence step by step,
        c_{-1} = 0, the second direction from the end (step t of the loop
        takes time t forward and time L-1-t backward)."""
        L, rows, d_in = x.shape
        H, O, nd = self.H, self.H * self.ndir, self.ndir
        u = matmul(x, self.weight).view(L, rows, nd, self.k, H)
        if u.is_meta:   # a FLOP count: the recurrence is elementwise, only its shape matters
            return u[:, :, :, 0].reshape(L, rows, O)
        skip = u[:, :, :, 3] if self.k == 4 else x.view(L, rows, nd, H)
        # each direction's time order: the second reads its inputs reversed
        order = [torch.arange(L, device=x.device)]
        if nd == 2:
            order.append(order[0].flip(0))
        pick = torch.stack(order, 1)                             # (L, nd)
        dirs = torch.arange(nd, device=x.device)
        u = u[pick, :, dirs].transpose(1, 2)                     # (L, rows, nd, k, H)
        skip = skip[pick, :, dirs].transpose(1, 2)               # (L, rows, nd, H)
        vf, vr = self.weight_c[:O].view(nd, H), self.weight_c[O:].view(nd, H)
        bf, br = self.bias[:O].view(nd, H), self.bias[O:].view(nd, H)
        c = torch.zeros((rows, nd, H), dtype=x.dtype, device=x.device)
        hs = []
        for t in range(L):
            f = torch.sigmoid(u[t, :, :, 1] + vf * c + bf)
            r = torch.sigmoid(u[t, :, :, 2] + vr * c + br)
            c = f * c + (1.0 - f) * u[t, :, :, 0]
            hs.append(r * c + (1.0 - r) * skip[t])
        h = torch.stack(hs)                                      # (L, rows, nd, H) in loop order
        h = h[pick, :, dirs].transpose(1, 2)                     # back to time order
        return h.reshape(L, rows, O)


class SRU(nn.Module):
    def __init__(self, d_in, H, num_layers, bidirectional):
        super().__init__()
        ndir = 2 if bidirectional else 1
        self.rnn_lst = nn.ModuleList(SRUCell(d_in if i == 0 else H * ndir, H, ndir)
                                     for i in range(num_layers))

    def forward(self, x):
        for cell in self.rnn_lst:
            x = cell(x)
        return x


class DualPathRNN(nn.Module):
    """k-sample windows along one axis (dim 4: F, dim 3: T), a bi-SRU over
    the windows with the other axis in the batch, a ConvTranspose back."""

    def __init__(self, in_chan, hid_chan, dim, kernel_size=8, stride=1, rnn_type="SRU",
                 num_layers=1, norm_type="LayerNormalization4D", bidirectional=True, **_):
        super().__init__()
        assert rnn_type == "SRU", "the reference holds the SRU only"
        self.dim, self.k, self.s = dim, kernel_size, stride
        self.norm = make_norm(norm_type, in_chan, 1)
        self.rnn = SRU(in_chan * kernel_size, hid_chan, num_layers, bidirectional)
        self.linear = ConvTranspose(hid_chan * (2 if bidirectional else 1), in_chan,
                                    kernel_size, 1, stride)

    def forward(self, x):
        if self.dim == 4:
            x = x.transpose(-2, -1)
        B, C, T, Fq = x.shape
        k, s = self.k, self.s
        nT = int(math.ceil((T - k) / s) * s + k)
        nF = int(math.ceil((Fq - k) / s) * s + k)
        x = F.pad(x, (0, nF - Fq, 0, nT - T))
        y = self.norm(x).permute(0, 3, 1, 2).reshape(B * nF, C, nT)
        y = self.rnn(unfold_1d(y, k, s).permute(2, 0, 1))   # (L, B·F, O)
        y = self.linear(y.permute(1, 2, 0))                  # (B·F, C, nT)
        y = (y.reshape(B, nF, C, nT).permute(0, 2, 3, 1) + x)[..., :T, :Fq]
        return y.transpose(-2, -1) if self.dim == 4 else y


LAYERS = {"DualPathRNN": DualPathRNN, "MultiHeadSelfAttention2D": MultiHeadSelfAttention2D,
          "GlobalAttention": GlobalAttention}


class InjectionMultiSum(nn.Module):
    def __init__(self, c, kernel_size, norm_type, is2d):
        super().__init__()

        def dw(act=None):
            return ConvNormAct(c, c, kernel_size, groups=c, norm_type=norm_type, act_type=act,
                               bias=False, is2d=is2d)

        self.local_embedding, self.global_embedding, self.global_gate = dw(), dw(), dw("Sigmoid")

    def forward(self, local, glob):
        shape = spatial(local)
        if math.prod(shape) > math.prod(spatial(glob)):
            emb = nearest(self.global_embedding(glob), shape)
            gate = nearest(self.global_gate(glob), shape)
        else:
            g = nearest(glob, shape)
            emb, gate = self.global_embedding(g), self.global_gate(g)
        return self.local_embedding(local) * gate + emb


class TDANetBlock(nn.Module):
    def __init__(self, in_chan, hid_chan, kernel_size, stride, norm_type, act_type,
                 upsampling_depth, layers, is2d):
        super().__init__()
        self.depth = upsampling_depth
        self.gateway = ConvNormAct(in_chan, in_chan, 1, groups=in_chan, act_type=act_type,
                                   is2d=is2d)
        self.projection = ConvNormAct(in_chan, hid_chan, 1, norm_type=norm_type,
                                      act_type=act_type, is2d=is2d)
        self.downsample_layers = nn.ModuleList(
            ConvNormAct(hid_chan, hid_chan, kernel_size, stride=1 if i == 0 else stride,
                        groups=hid_chan, norm_type=norm_type, is2d=is2d)
            for i in range(upsampling_depth))
        self.globalatt = nn.Sequential(*(
            LAYERS[c["layer_type"]](in_chan=hid_chan,
                                    **{k: v for k, v in c.items() if k != "layer_type"})
            for c in (layers or {}).values()))
        self.fusion_layers = nn.ModuleList(InjectionMultiSum(hid_chan, kernel_size, norm_type,
                                                             is2d) for _ in range(self.depth))
        self.concat_layers = nn.ModuleList(InjectionMultiSum(hid_chan, kernel_size, norm_type,
                                                             is2d)
                                           for _ in range(self.depth - 1))
        self.residual_conv = ConvNormAct(hid_chan, in_chan, 1, is2d=is2d)

    def forward(self, x):
        residual = self.gateway(x)
        down = [self.downsample_layers[0](self.projection(residual))]
        for layer in self.downsample_layers[1:]:
            down.append(layer(down[-1]))
        g = sum(avg_pool_to(f, down[-1].shape[2:]) for f in down)
        g = self.globalatt(g)
        fused = [self.fusion_layers[i](down[i], g) for i in range(self.depth)]
        up = self.concat_layers[-1](fused[-2], fused[-1]) + down[-2]
        for i in range(self.depth - 3, -1, -1):
            up = self.concat_layers[i](fused[i], up) + down[i]
        return self.residual_conv(up) + residual


class FRCNNBlock(nn.Module):
    def __init__(self, in_chan, hid_chan, kernel_size, stride, norm_type, act_type,
                 upsampling_depth, is2d):
        super().__init__()
        self.depth = upsampling_depth

        def dw(s):
            return ConvNormAct(hid_chan, hid_chan, kernel_size, stride=s, groups=hid_chan,
                               norm_type=norm_type, is2d=is2d)

        def merge(n):
            return ConvNormAct(n, hid_chan, 1, norm_type=norm_type, act_type=act_type,
                               is2d=is2d)

        self.gateway = ConvNormAct(in_chan, in_chan, 1, groups=in_chan, act_type=act_type,
                                   is2d=is2d)
        self.projection = ConvNormAct(in_chan, hid_chan, 1, is2d=is2d)
        self.downsample_layers = nn.ModuleList(dw(1 if i == 0 else stride)
                                               for i in range(upsampling_depth))
        self.fusion_layers = nn.ModuleList(nn.ModuleList([dw(stride)] if i else [])
                                           for i in range(upsampling_depth))
        self.concat_layers = nn.ModuleList(
            merge(hid_chan * (1 + (i > 0) + (i < upsampling_depth - 1)))
            for i in range(upsampling_depth))
        self.residual_conv = nn.Sequential(merge(hid_chan * upsampling_depth),
                                           ConvNormAct(hid_chan, in_chan, 1, is2d=is2d))

    def forward(self, x):
        residual = self.gateway(x)
        down = [self.downsample_layers[0](self.projection(residual))]
        for layer in self.downsample_layers[1:]:
            down.append(layer(down[-1]))
        fused = []
        for i, here in enumerate(down):
            parts = ([self.fusion_layers[i][0](down[i - 1])] if i else []) + [here]
            if i + 1 < self.depth:
                parts.append(nearest(down[i + 1], here.shape[2:]))
            fused.append(self.concat_layers[i](torch.cat(parts, dim=1)))
        target = down[0].shape[2:]
        merged = torch.cat([fused[0]] + [nearest(f, target) for f in fused[1:]], dim=1)
        return self.residual_conv(merged) + residual


class Repeated(nn.Module):
    """``blocks`` (shared) or ``blocks.{i}``; repeat i > 0 adds the input."""

    def __init__(self, make, repeats, shared):
        super().__init__()
        self.shared = shared
        self.blocks = make() if shared else nn.ModuleList(make() for _ in range(repeats))

    def block(self, i):
        return self.blocks if self.shared else self.blocks[i]


def separator(p, in_chan):
    kw = dict(in_chan=in_chan, hid_chan=p["hid_chan"], kernel_size=p.get("kernel_size", 5),
              stride=p.get("stride", 2), norm_type=p.get("norm_type", "gLN"),
              act_type=p.get("act_type", "PReLU"),
              upsampling_depth=p.get("upsampling_depth", 4), is2d=p.get("is2d", False))
    net = p.get("audio_net", p.get("video_net"))
    if net == "TDANet":
        return Repeated(lambda: TDANetBlock(layers=p.get("layers"), **kw), p["repeats"],
                        p.get("shared", False))
    if net == "FRCNN":
        return Repeated(lambda: FRCNNBlock(**kw), p["repeats"], p.get("shared", False))
    raise ValueError(f"the reference has no separator {net!r}")


class ATTNFusionCell(nn.Module):
    def __init__(self, ca, cb, kernel_size, is2d):
        super().__init__()
        self.ca, self.k, self.is2d = ca, kernel_size, is2d
        bn = "BatchNorm2d" if is2d else "BatchNorm1d"
        self.key_embed = ConvNormAct(ca, ca, 1, groups=ca, norm_type=bn, act_type="ReLU",
                                     bias=False, is2d=is2d)
        self.value_embed = ConvNormAct(ca, ca, 1, groups=ca, norm_type=bn, bias=False,
                                       is2d=is2d)
        self.attention_embed = ConvNormAct(cb, kernel_size * ca, 1, groups=ca, norm_type="gLN")
        self.resize = ConvNormAct(cb, ca, 1, groups=ca, norm_type="gLN")

    def forward(self, a, b):
        B, T = a.shape[0], a.shape[2]

        def to_a(t):
            t = nearest(t, (T,))
            return t[..., None] if self.is2d else t

        k1 = self.key_embed(a) * to_a(self.resize(b))
        att = self.attention_embed(b).reshape(B, self.ca, self.k, -1).mean(2)
        return k1 + to_a(torch.softmax(att, dim=-1)) * self.value_embed(a)


class ATTNFusion(nn.Module):
    def __init__(self, ca, cb, kernel_size, video_fusion, is2d):
        super().__init__()
        self.video_fusion = video_fusion
        if video_fusion:
            self.video_lstm = ATTNFusionCell(cb, ca, kernel_size, is2d)
        self.audio_lstm = ATTNFusionCell(ca, cb, kernel_size, is2d)

    def forward(self, a, v):
        return self.audio_lstm(a, v), self.video_lstm(v, a) if self.video_fusion else v


class ConcatFusion(nn.Module):
    def __init__(self, ca, cb, kernel_size, video_fusion, is2d):
        super().__init__()
        self.video_fusion = video_fusion
        self.audio_conv = ConvNormAct(ca + cb, ca, kernel_size, norm_type="gLN", is2d=is2d)
        if video_fusion:
            self.video_conv = ConvNormAct(ca + cb, cb, kernel_size, norm_type="gLN", is2d=is2d)

    def forward(self, a, v):
        assert a.dim() == v.dim(), "the reference fuses modalities of equal rank only"
        af = self.audio_conv(torch.cat([a, nearest(v, spatial(a))], dim=1))
        vf = (self.video_conv(torch.cat([nearest(a, spatial(v)), v], dim=1))
              if self.video_fusion else v)
        return af, vf


class MultiModalFusion(nn.Module):
    def __init__(self, ca, cb, kernel_size=1, fusion_repeats=3, fusion_type="ConcatFusion",
                 fusion_shared=False, is2d=False):
        super().__init__()
        self.shared = fusion_shared
        cls = {"ATTNFusion": ATTNFusion, "ConcatFusion": ConcatFusion}[fusion_type]
        if fusion_shared:
            self.fusion_module = cls(ca, cb, kernel_size, fusion_repeats > 1, is2d)
        else:
            self.fusion_module = nn.ModuleList(
                cls(ca, cb, kernel_size, i != fusion_repeats - 1, is2d)
                for i in range(fusion_repeats))

    def block(self, i):
        return self.fusion_module if self.shared else self.fusion_module[i]


class RefinementModule(nn.Module):
    def __init__(self, audio_params, video_params, ca, cv, fusion_params):
        super().__init__()
        self.fusion_repeats = video_params["repeats"]
        self.repeats = audio_params["repeats"]
        self.audio_net = separator(audio_params, ca)
        self.video_net = separator(video_params, cv)
        fkw = {k: fusion_params[k] for k in ("kernel_size", "fusion_type", "fusion_shared",
                                             "is2d") if k in fusion_params}
        self.crossmodal_fusion = MultiModalFusion(ca, cv, fusion_repeats=self.fusion_repeats,
                                                  **fkw)

    def forward(self, audio, video):
        a0, v0 = audio, video
        for i in range(self.repeats):
            audio = self.audio_net.block(i)(audio + a0 if i else audio)
            if i < self.fusion_repeats:
                video = self.video_net.block(i)(video + v0 if i else video)
                audio, video = self.crossmodal_fusion.block(i)(audio, video)
        return audio


# ------------------------------------------------------ encoder and decoder

class STFTEncoder(nn.Module):
    def __init__(self, win, hop_length, out_chan, kernel_size, bias=False, act_type=None,
                 norm_type=None, **_):
        super().__init__()
        self.win, self.hop, self.out_chan = win, hop_length, out_chan
        self.conv = ConvNormAct(2, out_chan, kernel_size, act_type=act_type,
                                norm_type=norm_type, bias=bias, is2d=True)

    def forward(self, x):
        window = torch.hann_window(self.win, dtype=torch.float32, device=x.device)
        spec = torch.stft(x.float(), self.win, self.hop, window=window, center=True,
                          pad_mode="reflect", return_complex=True)
        spec = torch.stack([spec.real, spec.imag], 1).transpose(2, 3).to(x.dtype)
        return self.conv(spec)                           # (B, N, T, F)


class STFTDecoder(nn.Module):
    def __init__(self, win, hop_length, in_chan, kernel_size, bias=False, **_):
        super().__init__()
        self.win, self.hop, self.in_chan = win, hop_length, in_chan
        self.decoder = ConvTranspose(in_chan, 2, kernel_size, 2, 1, (kernel_size - 1) // 2,
                                     bias=bias)

    def forward(self, x, length):
        y = self.decoder(x.reshape(-1, self.in_chan, *x.shape[-2:]))
        if y.is_meta:   # torch.istft has no meta kernel; a FLOP count needs the shape only
            return y.flatten(1)[:, :1].expand(-1, length)
        window = torch.hann_window(self.win, dtype=torch.float32, device=y.device)
        spec = torch.complex(y[:, 0].transpose(1, 2).float(), y[:, 1].transpose(1, 2).float())
        return torch.istft(spec, self.win, self.hop, window=window, center=True,
                           length=length).to(x.dtype)


class ConvolutionalEncoder(nn.Module):
    """One Conv1d branch (``encoder.0``), the input zero-padded to the
    multiples the separator's pyramid divides."""

    def __init__(self, out_chan, kernel_size, stride, act_type=None, norm_type="gLN",
                 bias=False, layers=1, upsampling_depth=4, **_):
        super().__init__()
        assert layers == 1, "the reference holds one encoder branch"
        self.k, self.out_chan, self.depth = kernel_size, out_chan, upsampling_depth
        self.encoder = nn.ModuleList([ConvNormAct(1, out_chan, kernel_size, stride=stride,
                                                  norm_type=norm_type, act_type=act_type,
                                                  bias=bias)])

    def forward(self, x):
        k2, up2 = self.k // 2, 2 ** self.depth
        g = math.gcd(k2, up2)
        x = x[:, None]
        for lcm in (abs(self.out_chan // 2 * up2) // g, abs(k2 * up2) // g):
            rem = x.shape[-1] % lcm
            x = F.pad(x, (0, lcm - rem)) if rem else x
        return self.encoder[0](x)


class ConvolutionalDecoder(nn.Module):
    def __init__(self, in_chan, kernel_size, stride, bias=False, **_):
        super().__init__()
        pad = (kernel_size - 1) // 2
        self.in_chan = in_chan
        self.decoder = ConvTranspose(in_chan, 1, kernel_size, 1, stride, pad, pad - 1,
                                     bias=bias)

    def forward(self, x, length):
        y = self.decoder(x.reshape(-1, self.in_chan, x.shape[-1]))
        y = F.pad(y, (0, length - y.shape[-1])) if y.shape[-1] < length else y
        return y[:, 0, :length]


class MaskGenerator(nn.Module):
    def __init__(self, n_src, audio_emb_dim, bottleneck_chan, kernel_size=1, mask_act="ReLU",
                 RI_split=False, is2d=False, **_):
        super().__init__()
        assert n_src == 1, "the reference separates one target"
        self.RI_split = RI_split
        self.mask_generator = nn.Sequential(
            PReLU(), ConvNormAct(bottleneck_chan, audio_emb_dim, kernel_size, act_type=mask_act,
                                 is2d=is2d))

    def forward(self, refined, emb):
        m = self.mask_generator(refined)
        if not self.RI_split:
            return m * emb
        h = emb.shape[1] // 2
        er, ei, mr, mi = emb[:, :h], emb[:, h:], m[:, :h], m[:, h:]
        return torch.cat([er * mr - ei * mi, er * mi + ei * mr], dim=1)


class AVNet(nn.Module):
    """encoder -> bottlenecks -> refinement -> masks -> decoder: (B, L)
    mixture and (B, C_v, T_v) lip embedding -> (B, L) target speech."""

    def __init__(self, n_src, enc_dec_params, audio_bn_params, audio_params,
                 mask_generation_params, pretrained_vout_chan, video_bn_params, video_params,
                 fusion_params, **_):
        super().__init__()
        e = dict(enc_dec_params)
        enc = {"STFTEncoder": STFTEncoder, "ConvolutionalEncoder": ConvolutionalEncoder}
        dec = {"STFTDecoder": STFTDecoder, "ConvolutionalDecoder": ConvolutionalDecoder}
        self.encoder = enc[e["encoder_type"]](
            upsampling_depth=audio_params.get("upsampling_depth", 1), **e)
        n = e["out_chan"]
        ca = audio_bn_params.get("out_chan", n)
        cv = video_bn_params.get("out_chan", pretrained_vout_chan)
        self.audio_bottleneck = ConvNormAct(**{**audio_bn_params, "in_chan": n, "out_chan": ca})
        self.video_bottleneck = ConvNormAct(**{**video_bn_params,
                                               "in_chan": pretrained_vout_chan})
        self.refinement_module = RefinementModule(audio_params, video_params, ca, cv,
                                                  fusion_params)
        self.mask_generator = MaskGenerator(n_src, n, ca, **mask_generation_params)
        self.decoder = dec[e["decoder_type"]](in_chan=n, **e)

    def forward(self, mix, emb):
        spec = self.encoder(mix)
        refined = self.refinement_module(self.audio_bottleneck(spec), self.video_bottleneck(emb))
        return self.decoder(self.mask_generator(refined, spec), mix.shape[-1])


# ------------------------------------------------------------- video model

class BasicBlock(nn.Module):
    def __init__(self, cin, planes, stride, downsample):
        super().__init__()
        self.conv1 = Conv(cin, planes, 3, 2, stride, 1, bias=False)
        self.bn1, self.relu1 = BatchNorm(planes), PReLU(planes)
        self.conv2 = Conv(planes, planes, 3, 2, 1, 1, bias=False)
        self.bn2, self.relu2 = BatchNorm(planes), PReLU(planes)
        self.downsample = (nn.Sequential(Conv(cin, planes, 1, 2, stride, 0, bias=False),
                                         BatchNorm(planes)) if downsample else None)

    def forward(self, x):
        out = self.bn2(self.conv2(self.relu1(self.bn1(self.conv1(x)))))
        return self.relu2(out + (x if self.downsample is None else self.downsample(x)))


class ResNet18(nn.Module):
    def __init__(self):
        super().__init__()
        cin = 64
        for i, (planes, stride) in enumerate(zip((64, 128, 256, 512), (1, 2, 2, 2))):
            blocks = [BasicBlock(cin, planes, stride, stride != 1 or cin != planes),
                      BasicBlock(planes, planes, 1, False)]
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))
            cin = planes

    def forward(self, x):
        for i in range(1, 5):
            x = getattr(self, f"layer{i}")(x)
        return x.mean(dim=(2, 3))


class FRCNNVideoModel(nn.Module):
    """(B, 1, T, H, W) frames -> Conv3d 5x7x7 / BN / PReLU -> max-pool ->
    ResNet-18 per frame -> (B, 512, T). Frozen: BatchNorms in eval mode."""

    def __init__(self, backbone_type="resnet", relu_type="prelu", **_):
        super().__init__()
        assert backbone_type == "resnet" and relu_type == "prelu"
        self.frontend3D = nn.Sequential(Conv(1, 64, (5, 7, 7), 3, (1, 2, 2), (2, 3, 3),
                                             bias=False), BatchNorm(64), PReLU(64))
        self.trunk = ResNet18()
        self.requires_grad_(False)
        self.eval()

    def forward(self, x):
        B = x.shape[0]
        y = F.max_pool3d(self.frontend3D(x), (1, 3, 3), (1, 2, 2), (0, 1, 1))
        T = y.shape[2]
        y = y.transpose(1, 2).reshape(B * T, 64, *y.shape[3:])
        return self.trunk(y).view(B, T, -1).transpose(1, 2)


# The weight rules of ``weights.py``: a tensor that a module of one of these
# classes holds itself, by its name, is drawn uniform on centre ± half-width;
# norm scales about 1, their shifts and running means about 0, PReLU slopes
# about 0.25, the SRU's gate vectors about 0.
_NORM = {"weight": (1.0, 0.1), "gamma": (1.0, 0.1), "bias": (0.0, 0.1), "beta": (0.0, 0.1),
         "running_mean": (0.0, 0.1), "running_var": (1.0, 0.25)}
INIT = {nn.GroupNorm: _NORM, LayerNormalization4D: _NORM, BatchNorm: _NORM, LayerNorm: _NORM,
        PReLU: {"weight": (0.25, 0.05)}, SRUCell: {"weight_c": (0.0, 0.1), "bias": (0.0, 0.1)}}


def build(conf):
    """(AVNet, video model) of a YAML config, parameters uninitialised."""
    return AVNet(**conf["audionet"]), FRCNNVideoModel(**conf["videonet"])
