"""PyTorch/CUDA port of ``rtfs_net_tpu`` for NVIDIA Hopper.

Module paths mirror ``rtfs_net_tpu/`` (``ops/rnn.py`` <-> ``ops/rnn.py``);
parameter names follow the reference torch implementation, so a port
``state_dict`` is what ``rtfs_net_tpu.utils.avnet_convert.convert_avnet``
consumes and reference checkpoints load with ``load_state_dict``.

The JAX package's Pallas kernels are hand-written CUDA kernels here, built
by ``nvcc`` at first use: the SRU layer recurrence
(``csrc/sru_stack_layer.cu`` for inference, ``csrc/sru_train.cu``, forward
and backward, under autograd), the stride-1 depthwise stencil
(``csrc/dw_conv.cu``) and the per-direction SRU recurrence
(``csrc/sru_direction.cu``); everything else is plain PyTorch. Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``;
``python -m rtfs_net_tpu_torch.train`` trains from a YAML config,
``.test`` evaluates an experiment, ``.separate`` separates a wav,
``.import_checkpoint`` ingests a reference checkpoint and ``.local_test``
runs a synthetic smoke epoch.

This ``__init__`` imports nothing: the data loader's spawned workers
import the package without loading torch.
"""

__version__ = "0.1.0"
