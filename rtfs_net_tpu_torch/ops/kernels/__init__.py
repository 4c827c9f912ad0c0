"""Hand-written CUDA kernels (sources in ``csrc/``) and their wrappers.

Each kernel is a registered operator of the ``rtfs`` namespace
(``registry.py``): its CUDA implementation launches the kernel, its CPU one
runs the plain PyTorch version beside it, and a fake one gives the output
shapes for ``torch.export``. Importing this package registers them all.

``KERNELS`` is the one list of them: a row per op with its module, the
module integer its CUDA implementation counts its launches in, the label
launch counts go by and the TPU kernel it replaces. Every other list of the
kernels (``OPS``, ``bench.launch_counts``, the tests, ``chip_smoke.py``'s
``kernels`` line) is read from it, so a new op is one new row (and its
shapes in ``scripts/torch_kernel_times.py``). By the repo's convention the
plain version of op ``<op>`` is ``<module>.<op>_ref`` and its CUDA
implementation ``<module>.<op>_cuda``.
"""
from typing import NamedTuple, Optional

from . import dual_path, dw_conv, sru, sru_direction, sru_train  # registers the ops


class Kernel(NamedTuple):
    op: str         # the op: torch.ops.rtfs.<op>
    module: object  # the wrapper module that launches it (its source: csrc/<module.SOURCE>)
    counter: str    # the module integer counting its launches
    label: str      # its name in launch counts
    replaces: Optional[str]  # the TPU kernel it stands for, if one has its work


KERNELS = (
    Kernel("sru_stack_layer", sru, "launches", "K1",
           "rtfs_net_tpu/ops/pallas/sru_kernel_v3.py:234"),
    Kernel("sru_train_forward", sru_train, "forward_launches", "K2_forward",
           "rtfs_net_tpu/ops/pallas/sru_train.py:154"),
    Kernel("sru_train_backward", sru_train, "backward_launches", "K2_backward",
           "rtfs_net_tpu/ops/pallas/sru_train.py:177"),
    Kernel("dw_conv2d_same", dw_conv, "launches", "K3", "rtfs_net_tpu/ops/pallas/dw_conv.py:131"),
    # K4, the per-direction SRU of the "pallas" route
    Kernel("sru_direction", sru_direction, "launches", "K4",
           "rtfs_net_tpu/ops/pallas/sru_kernel.py:92"),
    # the SRU DualPathRNN's passes into and out of K1's layout, and the LSTM
    # or GRU DualPathRNN's pass into cuDNN's window layout: the JAX package
    # leaves their layout changes to XLA's fusions
    Kernel("dual_path_norm_in", dual_path, "norm_in_launches", "dual_path_norm_in", None),
    Kernel("dual_path_out", dual_path, "out_launches", "dual_path_out", None),
    Kernel("dual_path_windows_in", dual_path, "windows_in_launches", "dual_path_windows_in",
           None),
)
OPS = tuple(k.op for k in KERNELS)

