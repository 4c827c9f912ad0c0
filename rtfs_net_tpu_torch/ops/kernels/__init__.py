"""Hand-written CUDA kernels (sources in ``csrc/``) and their wrappers.

Each wrapper launches its kernel for CUDA tensors, runs its plain PyTorch
version for CPU tensors, and counts its launches in a module integer
(``sru.launches``; ``sru_train.forward_launches`` and
``sru_train.backward_launches``; ``dw_conv.launches``;
``sru_direction.launches``).
"""
