"""The PyTorch port stands alone: nothing under ``rtfs_net_tpu_torch/``,
nothing in ``chip_smoke.py`` or the port's kernel scripts imports JAX, Flax
or the JAX package; and each
kernel's registered CUDA implementation launches its kernel or raises,
never runs its plain version instead."""
import ast
import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "rtfs_net_tpu")
PORT = sorted((ROOT / "rtfs_net_tpu_torch").rglob("*.py"))
FILES = PORT + [ROOT / "chip_smoke.py", ROOT / "scripts" / "torch_kernel_ab.py",
                ROOT / "scripts" / "torch_serving_ab.py",
                ROOT / "scripts" / "torch_sru_plans.py"]


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_has_modules():
    assert len(FILES) > 20 and (ROOT / "chip_smoke.py").exists()


def test_new_modules_are_covered():
    names = {str(p.relative_to(ROOT / "rtfs_net_tpu_torch")) for p in PORT}
    assert {"ops/kernels/dw_conv.py", "ops/kernels/sru_direction.py",
            "models/videomodels/__init__.py", "models/videomodels/resnet.py",
            "models/videomodels/frcnn_videomodel.py", "datas/__init__.py",
            "datas/wavio.py", "datas/transform.py", "datas/avspeech_dataset.py",
            "datas/loader.py", "utils/parser.py", "system/schedulers.py",
            "system/tb_writer.py", "system/checkpoint.py", "system/trainer.py",
            "models/serialization.py", "train.py", "_native.py", "metrics/__init__.py",
            "metrics/stoi.py", "metrics/pesq.py", "metrics/allwrapper.py", "utils/features.py",
            "utils/flops.py", "utils/profiling.py", "evaluation.py", "test.py", "separate.py",
            "local_test.py", "import_checkpoint.py", "export.py", "export_serving.py",
            "ops/kernels/registry.py", "models/separators/frcnn.py",
            "models/separators/repeats.py", "models/videomodels/shufflenetv2.py",
            "models/videomodels/autoencoder.py", "train_autoencoder.py",
            "find_unused_params.py"} <= names


def test_loader_workers_import_no_torch():
    """The data loader's spawned workers import the dataset's package and
    the entry point that started them (the main module: training,
    evaluation, the smoke run's fake dataset, or the autoencoder's mouth
    frames); none may load torch, which would cost each worker seconds and
    could open a CUDA context."""
    import subprocess
    import sys

    code = ("import sys, rtfs_net_tpu_torch.train, rtfs_net_tpu_torch.test, "
            "rtfs_net_tpu_torch.local_test, rtfs_net_tpu_torch.datas, "
            "rtfs_net_tpu_torch.train_autoencoder; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'jax')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=60, check=True).stdout
    assert out.strip() == "[]"


class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on a CUDA device, as a wrapper would
    see a tensor on a card."""

    device = property(lambda self: torch.device("cuda", 0))
    is_cuda = property(lambda self: True)


def _on_card(*shape):
    return torch.zeros(shape).as_subclass(_OnCard)


def _dw_conv_call(module):
    return module.dw_conv2d_same_cuda(_on_card(2, 3, 8, 8), _on_card(3, 1, 3, 3), [1, 1, 1, 1])


def _sru_stack_layer_call(module):
    return module.sru_stack_layer_cuda(_on_card(5, 3 * 8, 4), _on_card(5, 8, 4), _on_card(16),
                                       _on_card(16), 4, 3, 2)


def _sru_direction_call(module):
    return module.sru_direction_cuda(*(_on_card(5, 4, 8) for _ in range(4)),
                                     *(_on_card(8) for _ in range(4)), False)


def _sru_train_forward_call(module):
    return module.sru_train_forward_cuda(_on_card(5, 3 * 8, 4), _on_card(5, 8, 4), _on_card(16),
                                         _on_card(16), 4, 3, 2)


def _sru_train_backward_call(module):
    return module.sru_train_backward_cuda(_on_card(5, 3 * 8, 4), _on_card(5, 8, 4),
                                          _on_card(5, 8, 4), _on_card(16), _on_card(16),
                                          _on_card(5, 8, 4), 4, 3, 2)


# the plain version -> (its op, the CUDA implementation's launch count, its build cache)
OPS = {"dw_conv2d_same_ref": ("dw_conv2d_same", "launches", "_fn"),
       "sru_direction_ref": ("sru_direction", "launches", "_fn"),
       "sru_stack_layer_ref": ("sru_stack_layer", "launches", "_fn"),
       "sru_train_forward_ref": ("sru_train_forward", "forward_launches", "_fns"),
       "sru_train_backward_ref": ("sru_train_backward", "backward_launches", "_fns")}


@pytest.mark.parametrize("name,plain,call", [
    ("dw_conv", "dw_conv2d_same_ref", _dw_conv_call),
    ("sru_direction", "sru_direction_ref", _sru_direction_call),
    ("sru", "sru_stack_layer_ref", _sru_stack_layer_call),
    ("sru_train", "sru_train_forward_ref", _sru_train_forward_call),
    ("sru_train", "sru_train_backward_ref", _sru_train_backward_call),
])
def test_wrapper_raises_without_a_build(monkeypatch, tmp_path, name, plain, call):
    """Each op has a CUDA implementation registered, and that
    implementation, given tensors on a card and no ``nvcc``, fails to build
    its kernel and raises: the plain version is not taken in its place and
    no launch is counted. (The dispatcher sends a CPU tensor, which
    ``_OnCard`` is underneath, to the CPU implementation, so the CUDA one is
    called directly.)"""
    import importlib

    from rtfs_net_tpu_torch.ops.kernels import build

    module = importlib.import_module(f"rtfs_net_tpu_torch.ops.kernels.{name}")
    op, counter, cache = OPS[plain]
    assert torch._C._dispatch_has_kernel_for_dispatch_key(f"rtfs::{op}", "CUDA")

    def no_fallback(*args, **kwargs):
        raise AssertionError(f"{plain} ran for a CUDA tensor")

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(module, plain, no_fallback)
    monkeypatch.setattr(build, "nvcc", no_nvcc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_libs", {})
    getattr(module, cache).cache_clear()
    before = getattr(module, counter)
    with pytest.raises(RuntimeError, match="nvcc not found"), torch.no_grad():
        call(module)
    assert getattr(module, counter) == before
    getattr(module, cache).cache_clear()
