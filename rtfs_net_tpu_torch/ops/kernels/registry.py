"""The ``rtfs`` operator namespace: each kernel registered as a PyTorch
operator (``torch.ops.rtfs.<name>``), so that the dispatcher picks the
implementation by device and ``torch.export`` can trace through the call.

Each op has a ``CUDA`` implementation (the launch of the hand-written
kernel through ``ctypes``), a ``CPU`` one (the kernel's plain PyTorch
version) and a fake one that gives only the outputs' shapes and dtypes, for
tracing with fake tensors. None has an autograd formula of its own: the
differentiable kernels are ``torch.autograd.Function``s whose forward and
backward call the ops.
"""
from __future__ import annotations

import torch

NAMESPACE = "rtfs"
LIB = torch.library.Library(NAMESPACE, "DEF")


def define_op(schema: str, cuda, cpu, fake) -> None:
    """Define ``rtfs::<schema>`` and register its three implementations."""
    name = schema.split("(", 1)[0]
    LIB.define(schema)
    LIB.impl(name, cuda, "CUDA")
    LIB.impl(name, cpu, "CPU")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=LIB)
