"""Hand-written CUDA kernels (sources in ``csrc/``) and their wrappers.

Each kernel is a registered operator of the ``rtfs`` namespace
(``registry.py``): its CUDA implementation launches the kernel, its CPU one
runs the plain PyTorch version beside it, and a fake one gives the output
shapes for ``torch.export``. Importing this package registers all eight:
``rtfs::sru_stack_layer`` (K1), ``rtfs::sru_train_forward`` and
``rtfs::sru_train_backward`` (K2), ``rtfs::dw_conv2d_same`` (K3),
``rtfs::sru_direction`` (K4), ``rtfs::dual_path_norm_in`` and
``rtfs::dual_path_out``, the SRU DualPathRNN's passes into and out of K1's
layout, and ``rtfs::dual_path_windows_in``, the LSTM or GRU DualPathRNN's
pass into cuDNN's window layout, which replace no TPU kernel. Each CUDA
implementation counts its launches in a module integer (``sru.launches``;
``sru_train.forward_launches`` and ``sru_train.backward_launches``;
``dw_conv.launches``; ``sru_direction.launches``;
``dual_path.norm_in_launches``, ``dual_path.out_launches`` and
``dual_path.windows_in_launches``).
"""
from . import dual_path, dw_conv, sru, sru_direction, sru_train  # noqa: F401  (registers the ops)

OPS = ("sru_stack_layer", "sru_train_forward", "sru_train_backward", "dw_conv2d_same",
       "sru_direction", "dual_path_norm_in", "dual_path_out", "dual_path_windows_in")
