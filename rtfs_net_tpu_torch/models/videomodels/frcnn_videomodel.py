"""Frozen lip-encoder video models (reference
``src/models/videomodels/frcnn_videomodel.py`` and
``autoencoder_videomodel.py``).

``FRCNNVideoModel``: a Conv3d front-end (5x7x7, stride 1x2x2, then a
max-pool) -> a per-frame 2-D trunk (ResNet-18, or ShuffleNetV2 of
``width_mult``) -> a (B, backend_out, T_v) embedding.

The backbone is pretrained and frozen: its BatchNorms run in eval mode
even when the caller puts the model in training mode (reference
``frcnn_videomodel.py:78-83``), and its parameters take no gradient
unless the caller asks (``requires_grad_(True)``, as ``System`` does with
``train_video_model``). Parameter names are the reference's
(``frontend3D.{0,1,2}``, ``trunk.layer*`` or ``trunk.{0,1}.*``), so its
published state dict loads through ``utils.convert.load_video_backbone``.

``AEVideoModel``: the lip autoencoder's encoder applied per frame, frozen
the same way; ``train_autoencoder`` pretrains it.
"""
from __future__ import annotations

from torch import nn

from ...ops.conv import Conv, max_pool
from ...ops.normalizations import BatchNorm3d
from .autoencoder import EncoderAE
from .resnet import ResNet, activation
from .shufflenetv2 import STAGE_OUT_CHANNELS, ShuffleNetV2Trunk


class FRCNNVideoModel(nn.Module):
    def __init__(self, backbone_type: str = "resnet", relu_type: str = "prelu",
                 width_mult: float = 1.0):
        super().__init__()
        if backbone_type == "resnet":
            self.frontend_nout, self.backend_out = 64, 512
            trunk = ResNet(relu_type=relu_type)
        elif backbone_type == "shufflenet":
            self.frontend_nout = 24
            self.backend_out = STAGE_OUT_CHANNELS[width_mult][-1]
            trunk = ShuffleNetV2Trunk(width_mult=width_mult)
        else:
            raise ValueError(f"backbone_type must be 'resnet' or 'shufflenet', "
                             f"got {backbone_type!r}")
        n = self.frontend_nout
        self.frontend3D = nn.Sequential(
            Conv(1, n, (5, 7, 7), ndim=3, stride=(1, 2, 2), padding=(2, 3, 3), bias=False),
            BatchNorm3d(n),
            activation(relu_type, n),
        )
        self.trunk = trunk
        self.requires_grad_(False)
        self.eval()

    def train(self, mode: bool = True):
        """Training mode never reaches the BatchNorms: their statistics
        stay frozen."""
        super().train(mode)
        for m in self.modules():
            if isinstance(m, nn.modules.batchnorm._BatchNorm):
                m.training = False
        return self

    def forward(self, x):
        """x: (B, 1, T, H, W) mouth-ROI frames -> (B, backend_out, T)."""
        B = x.shape[0]
        y = max_pool(self.frontend3D(x), (1, 3, 3), (1, 2, 2), (0, 1, 1))
        T = y.shape[2]
        # 3-D -> per-frame 2-D: (B, C, T, H', W') -> (B*T, C, H', W')
        y = y.transpose(1, 2).reshape(B * T, self.frontend_nout, *y.shape[3:])
        return self.trunk(y).view(B, T, -1).transpose(1, 2)


class AEVideoModel(nn.Module):
    """The lip autoencoder's encoder on each frame (reference
    ``autoencoder_videomodel.py:9-80``): (B, C, T, H, W) ->
    (B, C'·H'·W', T), or with ``is2d`` (B, H'·W', T, C'), where C' =
    ``base_channels``·2^(num_layers-1) and H' = H / 2^num_layers."""

    def __init__(self, in_channels: int = 1, base_channels: int = 4, num_layers: int = 3,
                 is2d: bool = False):
        super().__init__()
        self.out_channels = base_channels * 2 ** (num_layers - 1)
        self.is2d = is2d
        self.encoder = EncoderAE(in_channels, base_channels, num_layers)
        self.requires_grad_(False)
        self.eval()

    def forward(self, x):
        B, C, T, H, W = x.shape
        z = self.encoder(x.transpose(1, 2).reshape(B * T, C, H, W))
        if self.is2d:
            return z.reshape(B, T, self.out_channels, -1).permute(0, 3, 1, 2)
        return z.reshape(B, T, -1).transpose(1, 2)
