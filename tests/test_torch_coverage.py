"""The port does everything the JAX package does: every public class and
function of every JAX module (outside ``ops/pallas/``, whose kernels have
their CUDA counterparts in ``rtfs_net_tpu_torch/csrc/``) has a counterpart
of the same name in the port's module at the same path, or is listed in
``LEFT_OUT`` with the reason; and the port's ``make_optimizer`` takes
every name of the JAX registry.

The same holds for the JAX side's tools outside the package: every
``.py`` under ``scripts/`` and ``data_preprocess/`` and every root CLI
that imports ``rtfs_net_tpu`` has a counterpart at
``rtfs_net_tpu_torch/<same relative path>``, or at the path ``PORTED_AT``
names, or is listed in ``LEFT_OUT_TOOLS`` with the reason."""
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


REPO = os.path.join(os.path.dirname(__file__), "..")
PORT_ROOT = os.path.join(REPO, "rtfs_net_tpu_torch")

# a JAX tool whose port lies at another path than its own -> that path
PORTED_AT = {
    "scripts/export_serving.py": "export_serving.py",
    "scripts/import_checkpoint.py": "import_checkpoint.py",
}
# a JAX tool (repo-relative path) -> why the port has no counterpart
LEFT_OUT_TOOLS = {
    "scripts/profile_hlo.py":
        "dumps XLA HLO; the port's counterpart is the kernel categories of "
        "python3 -m h100_bench --trace 1",
    "scripts/attr_fusions.py":
        "attributes time to XLA fusions; the port's counterparts are the per-layer "
        "breakdown of python3 -m h100_bench --trace 1 and "
        "rtfs_net_tpu_torch/scripts/profile_serving.py",
    "scripts/bench_interp.py":
        "times selection-matmul interpolation, a TPU lowering the North star leaves out",
    "scripts/bench_layout_r4.py":
        "times the tf_order layouts, a TPU lowering the North star leaves out",
    "scripts/bench_micro_r4.py":
        "times the tf_order and selection-matmul lowerings the North star leaves out",
    "scripts/bench_sru_train.py":
        "the Pallas backward against the scan backward; the port's counterpart is "
        "scripts/torch_kernel_times.py",
    "scripts/profile_stages.py":
        "the round-2 stage timing, superseded by profile_serving.py (its lines 5-6)",
    "__graft_entry__.py":
        "the JAX side's dry-run entry point; the port's is dryrun.py",
}


def _imports_jax_package(path):
    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                 [node.module] if isinstance(node, ast.ImportFrom) and node.level == 0 else [])
        if any(n.split(".")[0] == "rtfs_net_tpu" for n in names):
            return True
    return False


def _jax_tools():
    """Every tool of the JAX side outside its package that imports it."""
    paths = [os.path.join(d, f) for d in ("scripts", "data_preprocess")
             for f in sorted(os.listdir(os.path.join(REPO, d))) if f.endswith(".py")]
    paths += sorted(f for f in os.listdir(REPO) if f.endswith(".py"))
    return [p for p in paths if _imports_jax_package(p)]


@pytest.mark.parametrize("path", _jax_tools())
def test_every_jax_tool_has_a_counterpart(path):
    if path in LEFT_OUT_TOOLS:
        return
    port = os.path.join(PORT_ROOT, PORTED_AT.get(path, path))
    assert os.path.isfile(port), f"{path} has no counterpart at {port}"
    name = os.path.relpath(port, REPO)[:-len(".py")].replace(os.sep, ".")
    importlib.import_module(name)


def test_left_out_tools_exist_and_import_the_jax_package():
    for path in list(LEFT_OUT_TOOLS) + list(PORTED_AT):
        assert _imports_jax_package(path), path
    assert set(LEFT_OUT_TOOLS) | set(PORTED_AT) <= set(_jax_tools())


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
