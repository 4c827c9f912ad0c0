"""Hand-written CUDA kernels (sources in ``csrc/``) and their wrappers.

Each kernel is a registered operator of the ``rtfs`` namespace
(``registry.py``): its CUDA implementation launches the kernel, its CPU one
runs the plain PyTorch version beside it, and a fake one gives the output
shapes for ``torch.export``. Importing this package registers all five:
``rtfs::sru_stack_layer`` (K1), ``rtfs::sru_train_forward`` and
``rtfs::sru_train_backward`` (K2), ``rtfs::dw_conv2d_same`` (K3) and
``rtfs::sru_direction`` (K4). Each CUDA implementation counts its launches
in a module integer (``sru.launches``; ``sru_train.forward_launches`` and
``sru_train.backward_launches``; ``dw_conv.launches``;
``sru_direction.launches``).
"""
from . import dw_conv, sru, sru_direction, sru_train  # noqa: F401  (registers the ops)

OPS = ("sru_stack_layer", "sru_train_forward", "sru_train_backward", "dw_conv2d_same",
       "sru_direction")
