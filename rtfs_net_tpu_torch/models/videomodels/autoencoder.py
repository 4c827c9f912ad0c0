"""Lip autoencoder (reference ``src/models/videomodels/autoencoder/
autoencoder.py``; ``rtfs_net_tpu/models/videomodels/autoencoder.py``):
stride-2 2x2 conv blocks with an affine InstanceNorm and LeakyReLU(0.3),
trained with MSE on 88x88 mouth frames (``train_autoencoder.py``); its
encoder backs ``AEVideoModel``. Module names follow the JAX tree:
``encoder.layer{i}.conv``, ``encoder.layer{i}.norm``, likewise ``decoder``.
"""
from __future__ import annotations

from torch import nn
import torch.nn.functional as F

from ...ops.conv import Conv, ConvTranspose
from ...ops.normalizations import InstanceNorm2d

LEAKY_SLOPE = 0.3


class EncoderBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int):
        super().__init__()
        self.conv = Conv(in_channels, out_channels, kernel_size, ndim=2, stride=stride)
        self.norm = InstanceNorm2d(out_channels)

    def forward(self, x):
        return F.leaky_relu(self.norm(self.conv(x)), LEAKY_SLOPE)


class DecoderBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int):
        super().__init__()
        self.conv = ConvTranspose(in_channels, out_channels, kernel_size, ndim=2, stride=stride)
        self.norm = InstanceNorm2d(out_channels)

    def forward(self, x):
        return F.leaky_relu(self.norm(self.conv(x)), LEAKY_SLOPE)


class EncoderAE(nn.Module):
    """(N, C, H, W) -> (N, base·2^(L-1), H/2^L, W/2^L)."""

    def __init__(self, in_channels: int = 3, base_channels: int = 8, num_layers: int = 3):
        super().__init__()
        for i in range(num_layers):
            cout = base_channels * 2 ** i
            cin = in_channels if i == 0 else cout // 2
            self.add_module(f"layer{i}", EncoderBlock(cin, cout, 2, 2))

    def forward(self, x):
        for layer in self.children():
            x = layer(x)
        return x


class DecoderAE(nn.Module):
    """The encoder's mirror: ConvTranspose k2 s2 blocks back to
    ``in_channels`` at the input's size."""

    def __init__(self, in_channels: int = 3, base_channels: int = 8, num_layers: int = 3):
        super().__init__()
        for i in range(num_layers):
            cin = base_channels * 2 ** (num_layers - i - 1)
            cout = in_channels if i == num_layers - 1 else cin // 2
            self.add_module(f"layer{i}", DecoderBlock(cin, cout, 2, 2))

    def forward(self, x):
        for layer in self.children():
            x = layer(x)
        return x


class AE(nn.Module):
    """The full autoencoder for pretraining: loss = MSE(AE(x), x)."""

    def __init__(self, in_channels: int = 1, base_channels: int = 8, num_layers: int = 3):
        super().__init__()
        self.encoder = EncoderAE(in_channels, base_channels, num_layers)
        self.decoder = DecoderAE(in_channels, base_channels, num_layers)

    def forward(self, x):
        return self.decoder(self.encoder(x))
