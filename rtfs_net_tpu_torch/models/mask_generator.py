"""S³ mask generation (reference ``src/models/TDAVNet/mask_generator.py``).

``RI_split=True`` treats the embedding's channel halves as real and
imaginary parts and applies the mask as a complex product."""
from __future__ import annotations

from typing import Any

import torch
from torch import nn

from .layers import ConvNormAct
from ..ops.activations import PReLU, get as get_activation
from ..ops.conv import ConvTranspose


def _apply_masks(masks, emb, n_src: int, chan: int, RI_split: bool):
    """(B, n_src·chan, *sp) masks on a (B, chan, *sp) embedding ->
    (B, n_src, chan, *sp): a product, or with ``RI_split`` a complex one."""
    B = emb.shape[0]
    masks = masks.reshape(B, n_src, chan, *emb.shape[2:])
    if not RI_split:
        return masks * emb[:, None]
    half = chan // 2
    e_re, e_im = emb[:, None, :half], emb[:, None, half:]
    m_re, m_im = masks[:, :, :half], masks[:, :, half:]
    return torch.cat([e_re * m_re - e_im * m_im, e_re * m_im + e_im * m_re], dim=2)


def _gate_convs(chan: int, dw_gate: bool, is2d: bool):
    """The output gate's Tanh and Sigmoid 1x1 convs (``output``, ``gate``),
    depthwise with ``dw_gate``; the masks become output(m) * gate(m)."""
    groups = chan if dw_gate else 1
    return (ConvNormAct(chan, chan, 1, act_type="Tanh", is2d=is2d, groups=groups),
            ConvNormAct(chan, chan, 1, act_type="Sigmoid", is2d=is2d, groups=groups))


class MaskGenerator(nn.Module):
    """PReLU + ConvNormAct -> n_src·C masks as the reference's
    ``mask_generator`` Sequential, an optional Tanh x Sigmoid output gate,
    then the (complex) mask product (``mask_generator.py:20-99``). With
    ``direct`` it has no weights and returns the refined features as they
    are."""

    def __init__(self, n_src: int, audio_emb_dim: int, bottleneck_chan: int,
                 kernel_size: int = 1, mask_act: Any = "ReLU", RI_split: bool = False,
                 output_gate: bool = False, dw_gate: bool = False, direct: bool = False,
                 is2d: bool = False):
        super().__init__()
        self.n_src, self.in_chan, self.RI_split, self.direct = (n_src, audio_emb_dim,
                                                               RI_split, direct)
        if direct:
            return
        chan = n_src * audio_emb_dim
        self.mask_generator = nn.Sequential(
            PReLU(),
            ConvNormAct(bottleneck_chan, chan, kernel_size, act_type=mask_act, is2d=is2d))
        self.output_gate = output_gate
        if output_gate:
            self.output, self.gate = _gate_convs(chan, dw_gate, is2d)

    def forward(self, refined, emb):
        if self.direct:
            return refined
        masks = self.mask_generator(refined)
        if self.output_gate:
            masks = self.output(masks) * self.gate(masks)
        return _apply_masks(masks, emb, self.n_src, emb.shape[1], self.RI_split)


class MaskGenerator2Chan(nn.Module):
    """Masks for the raw 2-channel spectrogram (``mask_generator.py:102-187``):
    PReLU -> ConvTranspose2d to n_src·2 channels -> ``mask_act`` (the
    reference's ``mask_generator`` Sequential), an optional output gate,
    then the (complex) mask product; with ``direct`` the gated output,
    reshaped to (B, n_src, 2, *sp), is the result."""

    def __init__(self, n_src: int, bottleneck_chan: int, audio_emb_dim: int = 2,
                 kernel_size: int = 3, stride: int = 1, bias: bool = False,
                 mask_act: Any = "ReLU", RI_split: bool = False, output_gate: bool = False,
                 dw_gate: bool = False, direct: bool = False, is2d: bool = True):
        super().__init__()
        self.n_src, self.RI_split, self.direct = n_src, RI_split, direct
        chan = n_src * 2
        self.mask_generator = nn.Sequential(
            PReLU(),
            ConvTranspose(bottleneck_chan, chan, kernel_size, ndim=2, stride=stride,
                          padding=(kernel_size - 1) // 2, bias=bias),
            get_activation(mask_act)())
        self.output_gate = output_gate
        if output_gate:
            self.output, self.gate = _gate_convs(chan, dw_gate, True)

    def forward(self, refined, emb):
        masks = self.mask_generator(refined)
        if self.output_gate:
            masks = self.output(masks) * self.gate(masks)
        if self.direct:
            return masks.reshape(refined.shape[0], self.n_src, 2, *refined.shape[2:])
        return _apply_masks(masks, emb, self.n_src, 2, self.RI_split)


_REGISTRY = {"MaskGenerator": MaskGenerator, "MaskGenerator2Chan": MaskGenerator2Chan}


def get(identifier):
    if identifier is None:
        return MaskGenerator
    cls = _REGISTRY.get(identifier) if isinstance(identifier, str) else None
    if cls is None:
        raise ValueError(f"Could not interpret mask generator identifier: {identifier}")
    return cls
