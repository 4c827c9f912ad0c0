"""Refinement module (reference ``src/models/TDAVNet/refinement_module.py``):
``fusion_repeats`` iterations of audio block, video block and cross-modal
fusion, then the audio-only repeats, as a plain loop. Every repeat after
the first adds the module's input back (``x + residual``)."""
from __future__ import annotations

from typing import Any, Dict

from torch import nn

from . import separators
from .fusion import MultiModalFusion
from .layers import accepted_kwargs
from ..utils.profiling import span


def _separator(params: Dict[str, Any], which: str, in_chan: int) -> nn.Module:
    cls = separators.get(params.get(f"{which}_net"))
    if cls is separators.IdentitySeparator:
        return cls()
    kw = {k: v for k, v in params.items() if k not in ("audio_net", "video_net")}
    return cls(**accepted_kwargs(cls, {**kw, "in_chan": in_chan}))


class RefinementModule(nn.Module):
    def __init__(self, audio_params: Dict[str, Any], video_params: Dict[str, Any],
                 audio_bn_chan: int, video_bn_chan: int, fusion_params: Dict[str, Any]):
        super().__init__()
        self.fusion_repeats = video_params.get("repeats", 0)
        self.audio_repeats = audio_params["repeats"] - self.fusion_repeats
        self.audio_net = _separator(audio_params, "audio", audio_bn_chan)
        self.video_net = _separator(video_params, "video", video_bn_chan)
        fkw = {k: v for k, v in fusion_params.items()
               if k not in ("audio_bn_chan", "video_bn_chan", "fusion_repeats")}
        self.crossmodal_fusion = MultiModalFusion(
            audio_bn_chan, video_bn_chan, fusion_repeats=self.fusion_repeats,
            **accepted_kwargs(MultiModalFusion, fkw))

    def forward(self, audio, video=None):
        with span("rtfs.refinement"):
            audio_residual, video_residual = audio, video
            for i in range(self.fusion_repeats):
                audio = self.audio_net.get_block(i)(audio + audio_residual if i > 0 else audio)
                video = self.video_net.get_block(i)(video + video_residual if i > 0 else video)
                with span("rtfs.fusion"):
                    audio, video = self.crossmodal_fusion.get_fusion_block(i)(audio, video)
            for i in range(self.fusion_repeats, self.fusion_repeats + self.audio_repeats):
                audio = self.audio_net.get_block(i)(audio + audio_residual if i > 0 else audio)
            return audio
