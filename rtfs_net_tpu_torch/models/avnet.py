"""AVNet, the config-assembled model (reference ``src/models/tdavnet.py``):
encoder -> audio/video bottleneck convs -> RefinementModule -> mask
generator -> decoder, each chosen by a registry string of the YAML config."""
from __future__ import annotations

from typing import Any, Dict, Optional

from torch import nn

from . import decoders, encoders, mask_generator as mask_gen_mod
from .layers import ConvNormAct, accepted_kwargs
from .refinement import RefinementModule


class AVNet(nn.Module):
    def __init__(self, n_src: int, enc_dec_params: Dict[str, Any],
                 audio_bn_params: Dict[str, Any], audio_params: Dict[str, Any],
                 mask_generation_params: Dict[str, Any], pretrained_vout_chan: int = -1,
                 video_bn_params: Optional[Dict[str, Any]] = None,
                 video_params: Optional[Dict[str, Any]] = None,
                 fusion_params: Optional[Dict[str, Any]] = None):
        super().__init__()
        video_bn_params = video_bn_params or {}
        enc_cls = encoders.get(enc_dec_params["encoder_type"])
        self.encoder = enc_cls(**accepted_kwargs(enc_cls, {
            **enc_dec_params, "in_chan": 1,
            "upsampling_depth": audio_params.get("upsampling_depth", 1)}))
        enc_out_chan = self.encoder.out_chan
        audio_bn_chan = audio_bn_params.get("out_chan", enc_out_chan)
        video_bn_chan = video_bn_params.get("out_chan", pretrained_vout_chan)

        self.audio_bottleneck = ConvNormAct(**accepted_kwargs(
            ConvNormAct, {**audio_bn_params, "out_chan": audio_bn_chan,
                          "in_chan": enc_out_chan}))
        self.video_bottleneck = ConvNormAct(**accepted_kwargs(
            ConvNormAct, {**video_bn_params, "in_chan": pretrained_vout_chan}))
        self.refinement_module = RefinementModule(
            audio_params, video_params or {}, audio_bn_chan, video_bn_chan,
            fusion_params or {})

        mg_cls = mask_gen_mod.get(mask_generation_params.get("mask_generator_type"))
        self.mask_generator = mg_cls(**accepted_kwargs(mg_cls, {
            **mask_generation_params, "n_src": n_src, "audio_emb_dim": enc_out_chan,
            "bottleneck_chan": audio_bn_chan}))
        # Deviation kept from the JAX package (avnet.py:127-131): the
        # decoder's in_chan is per source (the reference passes
        # enc_out_chan * n_src); identical for n_src == 1.
        dec_cls = decoders.get(enc_dec_params["decoder_type"])
        self.decoder = dec_cls(**accepted_kwargs(dec_cls, {
            **enc_dec_params, "in_chan": enc_out_chan, "n_src": n_src}))

    def forward(self, audio_mixture, mouth_embedding=None):
        """(B, L) mixture [+ (B, C_v, T_v) lip embedding] -> (B, n_src, L)."""
        emb = self.encoder(audio_mixture)  # (B, N, T, F), or (B, N, T) in the time domain
        audio = self.audio_bottleneck(emb)
        video = None if mouth_embedding is None else self.video_bottleneck(mouth_embedding)
        refined = self.refinement_module(audio, video)
        separated = self.mask_generator(refined, emb)  # (B, n_src, N, T, F)
        shape = (audio_mixture.shape if audio_mixture.dim() > 1
                 else (1, audio_mixture.shape[0]))
        return self.decoder(separated, shape)
