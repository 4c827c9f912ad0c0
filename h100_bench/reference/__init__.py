"""The benchmark's plain reference: the models (``model.py``), the
training step's loss, clip and AdamW (``train.py``) and the precision of
the controls (``precision.py``). Plain PyTorch, independent of the program
under test.

Each configuration names its reference in ``<config>.json`` here:
``reference``, the path from the repository's root of the module that
holds its models; ``published``, the port's YAML that the configuration's
file copies; ``tiny``, the model at tiny widths that the CPU tests compare
with the port. A reference module

* exposes ``build(conf) -> (avnet, video_model)``, its parameters
  uninitialised, and ``INIT``, its weight rules for ``weights.py``: module
  class -> {tensor name: (centre, half-width)}; a module that adds rules
  extends ``model.INIT`` (``{**model.INIT, MyNorm: {...}}``);
* lies in this directory, uses plain ``torch`` and imports nothing of the
  port, of JAX or of the harness outside this directory; it may import
  ``model.py``'s building blocks (norms, ``ConvNormAct``,
  ``MultiHeadSelfAttention2D``, ``FRCNNVideoModel``, ...) rather than copy
  them;
* names its parameters and buffers as the port's state dict does, so one
  state dict loads into both;
* computes every module in its input's dtype and passes matmul and
  convolution operands through ``precision.q``, so that the bfloat16 and
  fp8 controls hold it as they hold ``model.py``;
* runs on the meta device (the FLOP count of ``work.py``) and in blocks of
  rows on the card (``check.py``)."""
