"""A plain reference module outside ``reference/``, for the test that a
configuration can arrive as new files only: ``model.py``'s models, and a
weight rule of its own for a module that holds a scale called ``weight``."""
import torch
from torch import nn

from h100_bench.reference import model


class Scale(nn.Module):
    """A per-channel scale, drawn about 0 as a lone vector without its rule."""

    def __init__(self, c):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c))


INIT = {**model.INIT, Scale: {"weight": (1.0, 0.1)}}
build = model.build
