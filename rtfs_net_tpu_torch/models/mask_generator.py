"""S³ mask generation (reference ``src/models/TDAVNet/mask_generator.py``).

``RI_split=True`` treats the embedding's channel halves as real and
imaginary parts and applies the mask as a complex product."""
from __future__ import annotations

from typing import Any

import torch
from torch import nn

from .layers import ConvNormAct
from ..ops.activations import PReLU


class MaskGenerator(nn.Module):
    """PReLU + ConvNormAct -> n_src·C masks as the reference's
    ``mask_generator`` Sequential, then the (complex) mask product
    (``mask_generator.py:20-99``)."""

    def __init__(self, n_src: int, audio_emb_dim: int, bottleneck_chan: int,
                 kernel_size: int = 1, mask_act: Any = "ReLU", RI_split: bool = False,
                 output_gate: bool = False, direct: bool = False, is2d: bool = False):
        super().__init__()
        if output_gate or direct:
            raise NotImplementedError("MaskGenerator output_gate/direct is not ported yet")
        self.n_src, self.in_chan, self.RI_split = n_src, audio_emb_dim, RI_split
        self.mask_generator = nn.Sequential(
            PReLU(),
            ConvNormAct(bottleneck_chan, n_src * audio_emb_dim, kernel_size,
                        act_type=mask_act, is2d=is2d))

    def forward(self, refined, emb):
        masks = self.mask_generator(refined)
        B, C = emb.shape[:2]
        masks = masks.reshape(B, self.n_src, C, *emb.shape[2:])
        if not self.RI_split:
            return masks * emb[:, None]
        half = C // 2
        e_re, e_im = emb[:, None, :half], emb[:, None, half:]
        m_re, m_im = masks[:, :, :half], masks[:, :, half:]
        return torch.cat([e_re * m_re - e_im * m_im, e_re * m_im + e_im * m_re], dim=2)


_REGISTRY = {"MaskGenerator": MaskGenerator}


def get(identifier):
    if identifier is None:
        return MaskGenerator
    cls = _REGISTRY.get(identifier) if isinstance(identifier, str) else None
    if cls is None:
        raise ValueError(f"Could not interpret mask generator identifier: {identifier}")
    return cls
