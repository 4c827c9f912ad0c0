"""Audio decoder (reference ``src/models/TDAVNet/decoder.py``), limited to
the RTFS-Net STFT back-end."""
from __future__ import annotations

from torch import nn

from ..ops import stft as stft_ops
from ..ops.conv import ConvTranspose


class STFTDecoder(nn.Module):
    """ConvTranspose2d to 2 channels -> complex -> iSTFT(length=L)
    (``decoder.py:72-132``)."""

    def __init__(self, win: int, hop_length: int, in_chan: int, n_src: int,
                 kernel_size: int = -1, stride: int = 1, bias: bool = False):
        super().__init__()
        self.win, self.hop_length, self.in_chan, self.n_src = win, hop_length, in_chan, n_src
        self.decoder = (ConvTranspose(in_chan, 2, kernel_size, ndim=2, stride=stride,
                                      padding=(kernel_size - 1) // 2, bias=bias,
                                      xavier_init=True)
                        if kernel_size > 0 else nn.Identity())

    def forward(self, x, input_shape):
        batch, length = input_shape[0], input_shape[-1]
        y = self.decoder(x.reshape(batch * self.n_src, self.in_chan, *x.shape[-2:]))
        wav = stft_ops.istft(y[:, 0].transpose(1, 2), y[:, 1].transpose(1, 2),
                             self.win, self.hop_length, length)
        return wav.reshape(batch, self.n_src, length).to(x.dtype)


_REGISTRY = {"STFTDecoder": STFTDecoder}


def get(identifier):
    cls = _REGISTRY.get(identifier) if isinstance(identifier, str) else None
    if cls is None:
        raise ValueError(f"Could not interpret decoder identifier: {identifier}")
    return cls
