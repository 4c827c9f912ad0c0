"""TDANet separator, the RTFS block container
(reference ``src/models/separators/tdanet.py``).

A TDANetBlock is: gateway depthwise 1x1 -> projection 1x1 -> strided
depthwise downsample pyramid -> adaptive-pool sum -> the config-built
global-attention stack (RTFS: DualPathRNN along F, DualPathRNN along T,
MHSA2D) -> per-scale InjectionMultiSum reconstruction -> residual conv.

In training mode every block call is checkpointed (the JAX package's
``remat=True``): its activations are dropped after the forward and
recomputed in the backward.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..layers import ConvNormAct, InjectionMultiSum, build
from ...ops.conv import adaptive_avg_pool
from ...ops.dropout import active_generator, use_generator


class TDANetBlock(nn.Module):
    def __init__(self, in_chan: int, hid_chan: int, kernel_size: int = 5,
                 stride: int = 2, norm_type: Any = "gLN", act_type: Any = "PReLU",
                 upsampling_depth: int = 4, layers: Optional[Dict[str, dict]] = None,
                 is2d: bool = False):
        super().__init__()
        self.depth = upsampling_depth
        self.gateway = ConvNormAct(in_chan, in_chan, 1, groups=in_chan,
                                   act_type=act_type, is2d=is2d)
        self.projection = ConvNormAct(in_chan, hid_chan, 1, norm_type=norm_type,
                                      act_type=act_type, is2d=is2d)
        self.downsample_layers = nn.ModuleList(
            ConvNormAct(hid_chan, hid_chan, kernel_size, stride=1 if i == 0 else stride,
                        groups=hid_chan, norm_type=norm_type, is2d=is2d)
            for i in range(upsampling_depth))
        self.globalatt = nn.Sequential(*(
            build(conf["layer_type"], in_chan=hid_chan,
                  **{k: v for k, v in conf.items() if k != "layer_type"})
            for conf in (layers or {}).values()))

        def inj():
            return InjectionMultiSum(hid_chan, kernel_size, norm_type, is2d=is2d)

        self.fusion_layers = nn.ModuleList(inj() for _ in range(upsampling_depth))
        self.concat_layers = nn.ModuleList(inj() for _ in range(upsampling_depth - 1))
        self.residual_conv = ConvNormAct(hid_chan, in_chan, 1, is2d=is2d)

    def forward(self, x):
        residual = self.gateway(x)
        downsampled = [self.downsample_layers[0](self.projection(residual))]
        for layer in self.downsample_layers[1:]:
            downsampled.append(layer(downsampled[-1]))
        target = downsampled[-1].shape[2:]
        global_features = sum(adaptive_avg_pool(f, target) for f in downsampled)
        global_features = self.globalatt(global_features)
        fused = [self.fusion_layers[i](downsampled[i], global_features)
                 for i in range(self.depth)]
        expanded = self.concat_layers[-1](fused[-2], fused[-1]) + downsampled[-2]
        for i in range(self.depth - 3, -1, -1):
            expanded = self.concat_layers[i](fused[i], expanded) + downsampled[i]
        return self.residual_conv(expanded) + residual


def checkpointed(block: nn.Module, x):
    """``block(x)`` under ``torch.utils.checkpoint``, with the recompute in
    the backward made to repeat the forward exactly:

    * dropout masks: the recompute draws from the same active generator,
      reset to its state at the forward call (``checkpoint`` itself only
      restores PyTorch's global generators), and the generator is put back
      where the forward left it afterwards;
    * BatchNorm statistics: the recompute's update of the running buffers
      is undone, so they move once per step, as JAX discards the
      recompute's ``batch_stats``."""
    generator = active_generator()
    start = None if generator is None else generator.get_state()
    calls = 0

    def run(inp):
        nonlocal calls
        calls += 1
        if calls == 1:
            return block(inp)
        after = None if generator is None else generator.get_state()
        buffers = [buf.clone() for buf in block.buffers()]
        if generator is not None:
            generator.set_state(start)
        try:
            with use_generator(generator):
                return block(inp)
        finally:
            if generator is not None:
                generator.set_state(after)
            with torch.no_grad():
                for buf, saved in zip(block.buffers(), buffers):
                    buf.copy_(saved)

    return checkpoint(run, x, use_reentrant=False)


class TDANet(nn.Module):
    """Repeat container (``tdanet.py:136-211``): ``shared=True`` reuses one
    block (``blocks``), else one block per repeat (``blocks.{i}``). With
    ``remat`` (the default, as in JAX), ``get_block`` returns a callable
    that checkpoints the block when it trains under autograd."""

    def __init__(self, in_chan: int = -1, hid_chan: int = -1, kernel_size: int = 5,
                 stride: int = 2, norm_type: Any = "gLN", act_type: Any = "PReLU",
                 upsampling_depth: int = 4, layers: Optional[Dict[str, dict]] = None,
                 repeats: int = 4, shared: bool = False, is2d: bool = False,
                 remat: bool = True):
        super().__init__()
        self.repeats, self.shared, self.remat = repeats, shared, remat

        def block():
            return TDANetBlock(in_chan, hid_chan, kernel_size, stride, norm_type,
                               act_type, upsampling_depth, layers, is2d)

        self.blocks = block() if shared else nn.ModuleList(block() for _ in range(repeats))

    def get_block(self, i: int):
        block = self.blocks if self.shared else self.blocks[i]

        def call(x):
            if self.remat and block.training and torch.is_grad_enabled():
                return checkpointed(block, x)
            return block(x)

        return call

    def forward(self, x):
        residual = x
        for i in range(self.repeats):
            x = self.get_block(i)(x + residual if i > 0 else x)
        return x
