"""The repeat container the separators share (the JAX package's TDANet and
FRCNN ``blocks``/``get_block``): one weight-shared block (``blocks``) or
one block per repeat (``blocks.{i}``), each repeat after the first adding
the container's input back.

In training mode under autograd every block call is checkpointed (the
JAX package's ``remat=True``): its activations are dropped after the
forward and recomputed in the backward.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...ops.dropout import active_generator, active_shard, use_generator


def checkpointed(block: nn.Module, x):
    """``block(x)`` under ``torch.utils.checkpoint``, with the recompute in
    the backward made to repeat the forward exactly:

    * dropout masks: the recompute draws from the same active generator
      (and batch shard), reset to its state at the forward call (``checkpoint`` itself only
      restores PyTorch's global generators), and the generator is put back
      where the forward left it afterwards;
    * BatchNorm statistics: the recompute's update of the running buffers
      is undone, so they move once per step, as JAX discards the
      recompute's ``batch_stats``."""
    generator, shard = active_generator(), active_shard()
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
            with use_generator(generator, shard):
                return block(inp)
        finally:
            if generator is not None:
                generator.set_state(after)
            with torch.no_grad():
                for buf, saved in zip(block.buffers(), buffers):
                    buf.copy_(saved)

    return checkpoint(run, x, use_reentrant=False)


class RepeatedBlocks(nn.Module):
    """``repeats`` block calls, ``x = block_i(x + input)`` for i > 0.
    ``get_block`` returns a callable that checkpoints the block when
    ``remat`` is set and the block trains under autograd. Without
    ``channels`` (the separator was given ``in_chan <= 0`` or ``hid_chan <=
    0``) no block is built and every repeat is the identity, so the output
    is ``repeats * x``, as in the JAX package."""

    def __init__(self, make_block: Callable[[], nn.Module], repeats: int, shared: bool,
                 remat: bool, channels: bool = True):
        super().__init__()
        self.repeats, self.shared, self.remat = repeats, shared, remat
        if not channels:
            self.blocks = None
        elif shared:
            self.blocks = make_block()
        else:
            self.blocks = nn.ModuleList(make_block() for _ in range(repeats))

    def get_block(self, i: int):
        if self.blocks is None:
            return lambda x: x
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
