"""Frozen lip-encoder video model (reference
``src/models/videomodels/frcnn_videomodel.py``): a Conv3d front-end
(5x7x7, stride 1x2x2, then a max-pool) -> a per-frame 2-D trunk
(ResNet-18) -> a (B, 512, T_v) embedding.

The backbone is pretrained and frozen: its BatchNorms run in eval mode
even when the caller puts the model in training mode (reference
``frcnn_videomodel.py:78-83``), and its parameters take no gradient
unless the caller asks (``requires_grad_(True)``, as ``System`` does with
``train_video_model``). Parameter names are the reference's
(``frontend3D.{0,1,2}``, ``trunk.layer*``), so its published state dict
loads through ``utils.convert.load_video_backbone``.
"""
from __future__ import annotations

from torch import nn

from ...ops.conv import Conv, max_pool
from ...ops.normalizations import BatchNorm3d
from .resnet import ResNet, activation


class FRCNNVideoModel(nn.Module):
    frontend_nout = 64
    backend_out = 512

    def __init__(self, backbone_type: str = "resnet", relu_type: str = "prelu"):
        super().__init__()
        if backbone_type != "resnet":
            raise NotImplementedError(f"backbone_type {backbone_type!r} is not ported yet")
        n = self.frontend_nout
        self.frontend3D = nn.Sequential(
            Conv(1, n, (5, 7, 7), ndim=3, stride=(1, 2, 2), padding=(2, 3, 3), bias=False),
            BatchNorm3d(n),
            activation(relu_type, n),
        )
        self.trunk = ResNet(relu_type=relu_type)
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
        """x: (B, 1, T, H, W) mouth-ROI frames -> (B, 512, T)."""
        B = x.shape[0]
        y = max_pool(self.frontend3D(x), (1, 3, 3), (1, 2, 2), (0, 1, 1))
        T = y.shape[2]
        # 3-D -> per-frame 2-D: (B, C, T, H', W') -> (B*T, C, H', W')
        y = y.transpose(1, 2).reshape(B * T, self.frontend_nout, *y.shape[3:])
        return self.trunk(y).view(B, T, -1).transpose(1, 2)


class AEVideoModel(nn.Module):
    """The conv-autoencoder backbone (reference
    ``autoencoder_videomodel.py``) is not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError("AEVideoModel is not ported yet")
