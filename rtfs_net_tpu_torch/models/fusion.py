"""Cross-modal fusion (reference ``src/models/TDAVNet/fusion.py``): six
audio<->video strategies. All but ATTNFusion make the two modalities' ranks
equal first by unsqueezing the lower-rank one (``wrangle_dims``), and
resize by nearest interpolation. ATTNFusion (the CAF block) is what the
RTFS-Net configs use, ConcatFusion what CTCNet uses."""
from __future__ import annotations

import torch
from torch import nn

from .layers import (
    ATTNFusionCell,
    ConvGRUFusionCell,
    ConvLSTMFusionCell,
    ConvNormAct,
    InjectionMultiSum,
)
from .layers.fusion_cells import _spatial_shape
from ..ops.conv import interpolate_nearest


def wrangle_dims(audio, video):
    """Unsqueeze the lower-rank modality so both have equal rank
    (``fusion.py:21-37``); returns (audio, video, x_flag, y_flag)."""
    t1, t2 = _spatial_shape(audio), _spatial_shape(video)
    x_flag, y_flag = len(t1) > len(t2), len(t2) > len(t1)
    return (audio[..., None] if y_flag else audio, video[..., None] if x_flag else video,
            x_flag, y_flag)


def unwrangle_dims(audio, video, x_flag, y_flag):
    return audio[..., 0] if y_flag else audio, video[..., 0] if x_flag else video


class ConcatFusion(nn.Module):
    """Each modality concatenated with the other resized to its shape, then
    a gLN conv back to its own channels (``audio_conv``, ``video_conv``)."""

    def __init__(self, ain_chan: int, vin_chan: int, kernel_size: int,
                 video_fusion: bool = True, is2d: bool = False):
        super().__init__()
        self.video_fusion = video_fusion

        def conv(out_chan):
            return ConvNormAct(ain_chan + vin_chan, out_chan, kernel_size, norm_type="gLN",
                               is2d=is2d)

        self.audio_conv = conv(ain_chan)
        if video_fusion:
            self.video_conv = conv(vin_chan)

    def forward(self, audio, video):
        audio, video, xf, yf = wrangle_dims(audio, video)
        audio_fused = self.audio_conv(
            torch.cat([audio, interpolate_nearest(video, _spatial_shape(audio))], dim=1))
        video_fused = (self.video_conv(torch.cat(
            [interpolate_nearest(audio, _spatial_shape(video)), video], dim=1))
            if self.video_fusion else video)
        return unwrangle_dims(audio_fused, video_fused, xf, yf)


class SumFusion(nn.Module):
    """Each modality plus a gLN conv of the other resized to its shape. The
    names are the reference's, swapped: ``video_conv`` maps video to
    audio, ``audio_conv`` audio to video (only with ``video_fusion``)."""

    def __init__(self, ain_chan: int, vin_chan: int, kernel_size: int,
                 video_fusion: bool = True, is2d: bool = False):
        super().__init__()
        self.video_fusion = video_fusion
        if video_fusion:
            self.audio_conv = ConvNormAct(ain_chan, vin_chan, kernel_size, norm_type="gLN",
                                          is2d=is2d)
        self.video_conv = ConvNormAct(vin_chan, ain_chan, kernel_size, norm_type="gLN",
                                      is2d=is2d)

    def forward(self, audio, video):
        audio, video, xf, yf = wrangle_dims(audio, video)
        video_fused = (self.audio_conv(interpolate_nearest(audio, _spatial_shape(video)))
                       + video if self.video_fusion else video)
        audio_fused = self.video_conv(interpolate_nearest(video, _spatial_shape(audio))) + audio
        return unwrangle_dims(audio_fused, video_fused, xf, yf)


class InjectionFusion(nn.Module):
    """Each modality's InjectionMultiSum (``audio_inj``, ``video_inj``) with
    the other, projected to its channels by a 1x1 conv, as the global
    features."""

    def __init__(self, ain_chan: int, vin_chan: int, kernel_size: int,
                 video_fusion: bool = True, is2d: bool = False):
        super().__init__()
        self.video_fusion = video_fusion
        if video_fusion:
            self.audio_conv = ConvNormAct(ain_chan, vin_chan, 1, is2d=is2d)
            self.video_inj = InjectionMultiSum(vin_chan, kernel_size, "gLN", is2d=is2d)
        self.video_conv = ConvNormAct(vin_chan, ain_chan, 1, is2d=is2d)
        self.audio_inj = InjectionMultiSum(ain_chan, kernel_size, "gLN", is2d=is2d)

    def forward(self, audio, video):
        audio, video, xf, yf = wrangle_dims(audio, video)
        video_fused = (self.video_inj(video, self.audio_conv(audio)) if self.video_fusion
                       else video)
        audio_fused = self.audio_inj(audio, self.video_conv(video))
        return unwrangle_dims(audio_fused, video_fused, xf, yf)


class _CellFusion(nn.Module):
    """One fusion cell per modality, named ``audio_lstm``/``video_lstm`` as
    in the reference whatever the cell (the video one only with
    ``video_fusion``)."""

    cell = None

    def __init__(self, ain_chan: int, vin_chan: int, kernel_size: int,
                 video_fusion: bool = True, is2d: bool = True, bidirectional: bool = True):
        super().__init__()
        self.video_fusion = video_fusion
        if video_fusion:
            self.video_lstm = self.cell(vin_chan, ain_chan, kernel_size, bidirectional, is2d)
        self.audio_lstm = self.cell(ain_chan, vin_chan, kernel_size, bidirectional, is2d)

    def forward(self, audio, video):
        audio, video, xf, yf = wrangle_dims(audio, video)
        video_fused = self.video_lstm(video, audio) if self.video_fusion else video
        return unwrangle_dims(self.audio_lstm(audio, video), video_fused, xf, yf)


class LSTMFusion(_CellFusion):
    cell = ConvLSTMFusionCell


class GRUFusion(_CellFusion):
    cell = ConvGRUFusionCell


class ATTNFusion(nn.Module):
    """Audio and (unless ``video_fusion`` is off) video ATTNFusionCells,
    named ``audio_lstm``/``video_lstm`` as in the reference; no rank
    wrangling (the cells take 4-D audio with 3-D video)."""

    def __init__(self, ain_chan: int, vin_chan: int, kernel_size: int,
                 video_fusion: bool = True, is2d: bool = True):
        super().__init__()
        self.video_fusion = video_fusion
        if video_fusion:
            self.video_lstm = ATTNFusionCell(vin_chan, ain_chan, kernel_size, is2d)
        self.audio_lstm = ATTNFusionCell(ain_chan, vin_chan, kernel_size, is2d)

    def forward(self, audio, video):
        video_fused = self.video_lstm(video, audio) if self.video_fusion else video
        return self.audio_lstm(audio, video), video_fused


_FUSIONS = {cls.__name__: cls for cls in (ConcatFusion, SumFusion, InjectionFusion,
                                          LSTMFusion, GRUFusion, ATTNFusion)}


class MultiModalFusion(nn.Module):
    """Shared or per-repeat fusion blocks; the last repeat does no video
    fusion (``fusion.py:215-281``). The refinement module calls the blocks
    one repeat at a time (``get_fusion_block``); ``forward`` runs them
    alone, each repeat after the first on its inputs plus the first's."""

    def __init__(self, audio_bn_chan: int, video_bn_chan: int, kernel_size: int = 1,
                 fusion_repeats: int = 3, fusion_type: str = "ConcatFusion",
                 fusion_shared: bool = False, is2d: bool = False):
        super().__init__()
        self.fusion_repeats, self.fusion_shared = fusion_repeats, fusion_shared
        if fusion_repeats <= 0:
            return
        cls = _FUSIONS[fusion_type]
        kw = dict(ain_chan=audio_bn_chan, vin_chan=video_bn_chan,
                  kernel_size=kernel_size, is2d=is2d)
        self.fusion_module = (
            cls(video_fusion=fusion_repeats > 1, **kw) if fusion_shared else
            nn.ModuleList(cls(video_fusion=i != fusion_repeats - 1, **kw)
                          for i in range(fusion_repeats)))

    def get_fusion_block(self, i: int) -> nn.Module:
        return self.fusion_module if self.fusion_shared else self.fusion_module[i]

    def forward(self, audio, video):
        audio_fused, video_fused = audio, video
        for i in range(self.fusion_repeats):
            audio_fused, video_fused = self.get_fusion_block(i)(
                audio_fused + audio if i else audio, video_fused + video if i else video)
        return audio_fused
