"""Normalizations with the reference's parameter names
(``src/models/layers/normalizations.py``).

Statistics and the affine are computed in float32 and the result is cast
back to the input's dtype, so a bfloat16 forward normalizes like the JAX
package does. Parameters stay float32.
"""
from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

EPS = 1e-5


class GlobalLayerNorm(nn.Module):
    """gLN: ``nn.GroupNorm(1, C)`` semantics over channel and every spatial
    dim, its parameters kept as the child ``norm`` (reference key
    ``<prefix>.norm.weight``).

    The statistics are one ``var_mean`` over dims 1.. rather than
    ``F.group_norm``: PyTorch's CUDA group norm computes each (sample,
    group) row's moments in one thread block, so with one group a
    (256, 251, 129) sample's 8.3 M elements run on a single SM."""

    def __init__(self, num_channels: int, eps: float = EPS):
        super().__init__()
        self.norm = nn.GroupNorm(1, num_channels, eps=eps)

    def forward(self, x):
        n = self.norm
        xf = x.float()
        var, mean = torch.var_mean(xf, dim=tuple(range(1, x.dim())), correction=0,
                                   keepdim=True)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        scale = torch.rsqrt(var + n.eps) * n.weight.float().view(shape)
        shift = torch.addcmul(n.bias.float().view(shape), mean, scale, value=-1)
        return torch.addcmul(shift, xf, scale).to(x.dtype)


class LayerNormalization4D(nn.Module):
    """LN over (C,) or (C, F) of a (B, C, T, F) tensor. With ``param_freq``
    > 1 the affine is (1, C, 1, F) and statistics run over dims (1, 3),
    else over dim 1 only (biased variance)."""

    def __init__(self, num_channels: int, param_freq: int = 1, eps: float = EPS):
        super().__init__()
        shape = (1, num_channels, 1, param_freq)
        self.gamma = nn.Parameter(torch.ones(shape))
        self.beta = nn.Parameter(torch.zeros(shape))
        self.dims = (1, 3) if param_freq > 1 else (1,)
        self.eps = eps

    def forward(self, x):
        xf = x.float()
        var, mean = torch.var_mean(xf, dim=self.dims, correction=0, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        return (y * self.gamma.float() + self.beta.float()).to(x.dtype)


class InstanceNorm2d(nn.InstanceNorm2d):
    """``nn.InstanceNorm2d(C, affine=True)`` in float32: each sample's
    channels normalized over H, W (biased variance), then the per-channel
    affine ``weight``/``bias`` (the JAX package's ``scale``/``bias``,
    ``rtfs_net_tpu/models/videomodels/autoencoder.py:14-28``)."""

    def __init__(self, num_features: int, eps: float = EPS):
        super().__init__(num_features, eps=eps, affine=True)

    def forward(self, x):
        return F.instance_norm(x.float(), weight=self.weight.float(), bias=self.bias.float(),
                               eps=self.eps).to(x.dtype)


class _FloatBatchNorm:
    def forward(self, x):
        return super().forward(x.float()).to(x.dtype)


class BatchNorm(_FloatBatchNorm, nn.modules.batchnorm._BatchNorm):
    """Batch norm over dim 1 of an input of any rank (the JAX package's
    ``BatchNorm``, whose dimensionality follows the input)."""

    def _check_input_dim(self, x):
        if x.dim() < 2:
            raise ValueError(f"expected an input with a channel dim, got {x.dim()}D")


class BatchNorm1d(_FloatBatchNorm, nn.BatchNorm1d):
    pass


class BatchNorm2d(_FloatBatchNorm, nn.BatchNorm2d):
    pass


class BatchNorm3d(_FloatBatchNorm, nn.BatchNorm3d):
    pass


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` over the trailing dims, in float32."""

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                            self.bias.float(), self.eps).to(x.dtype)


Identity = nn.Identity
gLN = GlobalLayerNorm
LN4d = LayerNormalization4D

_REGISTRY = {
    "gln": GlobalLayerNorm,
    "globallayernorm": GlobalLayerNorm,
    "groupnorm1": GlobalLayerNorm,
    "layernormalization4d": LayerNormalization4D,
    "ln4d": LayerNormalization4D,
    "batchnorm1d": BatchNorm1d,
    "batchnorm2d": BatchNorm2d,
    "batchnorm3d": BatchNorm3d,
    "layernorm": LayerNorm,
    "identity": Identity,
}


def get(identifier):
    if identifier is None:
        return Identity
    if callable(identifier):
        return identifier
    if isinstance(identifier, str):
        cls = _REGISTRY.get(identifier.lower())
        if cls is not None:
            return cls
    raise ValueError(f"Could not interpret normalization identifier: {identifier}")
