"""STFT / iSTFT as ``torch.stft``/``torch.istft`` (the reference's own
calls, ``encoder.py:164-170`` / ``decoder.py:122-128``): centred with
reflect padding, onesided, periodic Hann window, ``length=`` cropping.
Both transforms run in float32 whatever the activation dtype."""
from __future__ import annotations

import torch


def _window(n_fft: int, device) -> torch.Tensor:
    return torch.hann_window(n_fft, periodic=True, dtype=torch.float32, device=device)


def stft(x: torch.Tensor, n_fft: int, hop_length: int, center: bool = True):
    """x: (B, L) -> (real, imag), each (B, F, T) float32 with F = n_fft//2+1
    and T = 1 + L//hop when centred."""
    assert x.dim() == 2
    spec = torch.stft(x.float(), n_fft, hop_length, window=_window(n_fft, x.device),
                      center=center, pad_mode="reflect", return_complex=True)
    return spec.real, spec.imag


def istft(real: torch.Tensor, imag: torch.Tensor, n_fft: int, hop_length: int,
          length: int, center: bool = True) -> torch.Tensor:
    """real/imag: (B, F, T) -> (B, length) float32."""
    spec = torch.complex(real.float(), imag.float())
    return torch.istft(spec, n_fft, hop_length, window=_window(n_fft, real.device),
                       center=center, length=length)
