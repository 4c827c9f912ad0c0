"""Cross-modal fusion (reference ``src/models/TDAVNet/fusion.py``), limited
to ATTNFusion (the CAF block of the RTFS-Net configs)."""
from __future__ import annotations

from torch import nn

from .layers import ATTNFusionCell


class ATTNFusion(nn.Module):
    """Audio and (unless ``video_fusion`` is off) video ATTNFusionCells,
    named ``audio_lstm``/``video_lstm`` as in the reference."""

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


_FUSIONS = {"ATTNFusion": ATTNFusion}


class MultiModalFusion(nn.Module):
    """Shared or per-repeat fusion blocks; the last repeat does no video
    fusion (``fusion.py:215-281``)."""

    def __init__(self, audio_bn_chan: int, video_bn_chan: int, kernel_size: int = 1,
                 fusion_repeats: int = 3, fusion_type: str = "ConcatFusion",
                 fusion_shared: bool = False, is2d: bool = False):
        super().__init__()
        self.fusion_repeats, self.fusion_shared = fusion_repeats, fusion_shared
        if fusion_repeats <= 0:
            return
        if fusion_type not in _FUSIONS:
            raise NotImplementedError(f"fusion_type {fusion_type!r} is not ported yet")
        cls = _FUSIONS[fusion_type]
        kw = dict(ain_chan=audio_bn_chan, vin_chan=video_bn_chan,
                  kernel_size=kernel_size, is2d=is2d)
        self.fusion_module = (
            cls(video_fusion=fusion_repeats > 1, **kw) if fusion_shared else
            nn.ModuleList(cls(video_fusion=i != fusion_repeats - 1, **kw)
                          for i in range(fusion_repeats)))

    def get_fusion_block(self, i: int) -> nn.Module:
        return self.fusion_module if self.fusion_shared else self.fusion_module[i]
