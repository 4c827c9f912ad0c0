"""The port does everything the JAX package does: every public class and
function of every JAX module (outside ``ops/pallas/``, whose kernels have
their CUDA counterparts in ``rtfs_net_tpu_torch/csrc/``) has a counterpart
of the same name in the port's module at the same path, or is listed in
``LEFT_OUT`` with the reason; and the port's ``make_optimizer`` takes
every name of the JAX registry."""
import ast
import importlib
import os

import pytest
import torch

from rtfs_net_tpu_torch.system import optimizers

from _torch_port import jax_optimizer_names, one_torch_thread  # noqa: F401

JAX_ROOT = os.path.join(os.path.dirname(__file__), "..", "rtfs_net_tpu")

# (module path, name) -> why the port has no counterpart; a whole module is
# listed by its path with the name "*"
LEFT_OUT = {
    ("models/__init__.py", "for_inference"):
        "a view that unrolls JAX's scan over shared repeats; the port's repeats are a loop",
    ("utils/cache.py", "*"): "XLA compilation cache and flags; PyTorch compiles nothing",
    ("ops/conv.py", "torch_conv_init"):
        "an init helper; the port's modules initialise in reset_parameters",
    ("ops/conv.py", "xavier_uniform_init"):
        "an init helper; the port's modules initialise in reset_parameters",
    ("models/videomodels/resnet.py", "kaiming_normal_conv"):
        "an init helper; the port's ResNet initialises in reset_parameters",
    ("utils/flops.py", "flops_report"):
        "XLA's cost analysis; conv_dot_macs counts the MACs in the port",
    ("utils/avnet_convert.py", "*"):
        "reference state dict -> JAX variables; the port loads reference names directly",
    ("utils/torch_convert.py", "*"):
        "reference video state dict -> JAX variables; the port loads it by name",
    ("parallel/mesh.py", "batch_sharded"): "a jax.sharding spec; DDP shards the batch",
    ("parallel/mesh.py", "replicated"): "a jax.sharding spec; DDP replicates the model",
    ("system/core.py", "TrainState"):
        "flax's train state; the port's System holds the model and optimizer",
    ("ops/stft.py", "hann_window"): "the JAX STFT's window; the port calls torch.stft",
    ("ops/stft.py", "stft_frames"): "the JAX STFT's framing; the port calls torch.stft",
}


def _jax_modules():
    for root, dirs, files in os.walk(JAX_ROOT):
        dirs[:] = sorted(d for d in dirs if d not in ("pallas", "configs", "__pycache__"))
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.relpath(os.path.join(root, f), JAX_ROOT)


def _public_names(path):
    with open(os.path.join(JAX_ROOT, path)) as f:
        tree = ast.parse(f.read())
    return [n.name for n in tree.body if isinstance(n, (ast.ClassDef, ast.FunctionDef))
            and not n.name.startswith("_")]


def _port_module(path):
    name = path[:-len(".py")].replace(os.sep, ".")
    name = name[:-len(".__init__")] if name.endswith(".__init__") else name
    return "rtfs_net_tpu_torch" + ("" if name == "__init__" else "." + name)


@pytest.mark.parametrize("path", list(_jax_modules()))
def test_every_public_name_has_a_counterpart(path):
    names = _public_names(path)
    if (path, "*") in LEFT_OUT:
        return
    module = importlib.import_module(_port_module(path))
    missing = [n for n in names if not hasattr(module, n) and (path, n) not in LEFT_OUT]
    assert not missing, f"{_port_module(path)} lacks {missing}"


def test_left_out_names_exist_in_the_jax_package():
    for path, name in LEFT_OUT:
        assert name == "*" or name in _public_names(path), (path, name)


def test_make_optimizer_takes_every_jax_name():
    assert sorted(optimizers.NAMES) == jax_optimizer_names()
    w = [torch.nn.Parameter(torch.ones(3))]
    for name in jax_optimizer_names():
        opt = optimizers.make_optimizer(w, name)
        w[0].grad = torch.full((3,), 0.1)
        opt.step()
        assert bool(torch.isfinite(w[0]).all()), name
