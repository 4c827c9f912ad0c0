"""Standalone inference helper (reference ``src/utils/separator.py``):
``separate()`` runs the model and rescales the output's energy to the
input's."""
from __future__ import annotations

import numpy as np
import torch

from ..models import resolve_device
from .profiling import span


def separate(model, wav, mouth_emb=None, *, video_model=None, device="cuda",
             dtype=torch.float32):
    """Separate a (B, L) mixture, optionally conditioned on a (B, C, T_v)
    lip embedding; returns (B, n_src, L) float32 on ``device``, or numpy if
    ``wav`` was numpy. With ``video_model``, the third argument is the raw
    (B, 1, T_v, H, W) mouth-ROI frames and the embedding is computed from
    them first. Both forwards run on ``device`` in ``dtype`` (float32 or
    bfloat16) without autograd; the output is rescaled so that
    sum|out| == sum|wav| over the whole batch (reference ``separator.py:55``).
    """
    device = resolve_device(device)
    was_numpy = isinstance(wav, np.ndarray)
    if video_model is not None and mouth_emb is None:
        raise ValueError("video_model needs the mouth-ROI frames as the third argument")
    with span("rtfs.separate", f"batch={len(wav)}"):
        with span("rtfs.separate.upload"):
            x = torch.as_tensor(wav, device=device, dtype=torch.float32)
            inp = x.to(dtype)
            emb = (None if mouth_emb is None
                   else torch.as_tensor(mouth_emb, device=device).to(dtype))
        with torch.inference_mode():
            if video_model is not None:
                with span("rtfs.video"):
                    emb = video_model(emb)
            with span("rtfs.avnet"):
                out = model(inp, emb)
            out = out.float()
            out = out * (x.abs().sum() / (out.abs().sum() + 1e-8))
        if not was_numpy:
            return out
        with span("rtfs.separate.download"):
            return out.cpu().numpy()
