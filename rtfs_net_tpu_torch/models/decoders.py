"""Audio decoders (reference ``src/models/TDAVNet/decoder.py``): the
CTCNet transposed conv and the RTFS-Net STFT back-end."""
from __future__ import annotations

from torch import nn
import torch.nn.functional as F

from ..ops import stft as stft_ops
from ..ops.conv import ConvTranspose


def pad_to_input_length(x, length: int):
    """Zero-pad the last dim up to ``length`` when it is shorter."""
    return F.pad(x, (0, length - x.shape[-1])) if x.shape[-1] < length else x


class ConvolutionalDecoder(nn.Module):
    """ConvTranspose1d back to the waveform (``decoder.py:25-69``): padding
    (k-1)//2 and output padding one less, then padded or cut to the
    input's length L."""

    def __init__(self, in_chan: int, n_src: int, kernel_size: int, stride: int,
                 bias: bool = False):
        super().__init__()
        self.in_chan, self.n_src = in_chan, n_src
        pad = (kernel_size - 1) // 2
        self.decoder = ConvTranspose(in_chan, 1, kernel_size, ndim=1, stride=stride,
                                     padding=pad, output_padding=pad - 1, bias=bias,
                                     xavier_init=True)

    def forward(self, x, input_shape):
        batch, length = input_shape[0], input_shape[-1]
        y = self.decoder(x.reshape(batch * self.n_src, self.in_chan, -1))
        y = pad_to_input_length(y, length)
        return y.reshape(batch, self.n_src, -1)[..., :length]


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


_REGISTRY = {"ConvolutionalDecoder": ConvolutionalDecoder, "STFTDecoder": STFTDecoder}


def get(identifier):
    cls = _REGISTRY.get(identifier) if isinstance(identifier, str) else None
    if cls is None:
        raise ValueError(f"Could not interpret decoder identifier: {identifier}")
    return cls
