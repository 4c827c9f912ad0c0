"""The port's serving artifact (``rtfs_net_tpu_torch/export.py``) and its CLI
(``rtfs_net_tpu_torch/export_serving.py``), on the CPU.

On the tiny AV config of ``tests/test_torch_avnet.py`` cut to one repeat and
one SRU layer per DualPathRNN (``torch.export.load`` of its ~1200-node
graph takes seconds on a CPU), and on the same config without its video
branch, float32, traced on the CPU:

* the CLI's (1, 2)-bucket artifact matches the port's eager forward (atol
  1e-5, rtol 1e-4, the tolerance of ``tests/test_export.py``) and the JAX
  package's ``model.apply`` on the same weights, carried through
  ``state_dict_from_jax`` (5e-4·max|out|, the tolerance of
  ``tests/test_torch_avnet.py``); its shapes are pinned; it serves
  n = 1, 2, 3, 5 by padding and chunking; a one-bucket audio-only file
  round-trips through ``load_serving``;
* the graph holds a ``rtfs::sru_stack_layer`` node per SRU layer, a
  ``rtfs::dual_path_norm_in`` and a ``rtfs::dual_path_out`` node per
  DualPathRNN and no training-kernel node; with the depthwise convs sent to the stencil op on
  the CPU too, ``rtfs::dw_conv2d_same`` nodes that run the plain version;
* each loader refuses the other package's files; loading imports no model
  code; the CLI exports the audio-only convention end to end.
"""
import copy
import os
import struct
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtfs_net_tpu.export import _read_frame as jax_read_frame
from rtfs_net_tpu.models import AVNet as JaxAVNet
from rtfs_net_tpu.utils.avnet_convert import convert_avnet
from rtfs_net_tpu_torch import export as E
from rtfs_net_tpu_torch import export_serving
from rtfs_net_tpu_torch.models import build_model, serialization
from rtfs_net_tpu_torch.ops import conv
from rtfs_net_tpu_torch.utils.convert import state_dict_from_jax

from _torch_port import jax_apply, one_torch_thread  # noqa: F401
from test_torch_avnet import TINY as AVNET_TINY
from test_torch_avnet import TV, L

ROOT = os.path.join(os.path.dirname(__file__), "..")
TINY = copy.deepcopy(AVNET_TINY)
TINY["audio_params"]["repeats"] = 1
for _layer in ("layer_1", "layer_2"):
    TINY["audio_params"]["layers"][_layer]["num_layers"] = 1
EMB = TINY["pretrained_vout_chan"]
SRU_LAYERS = 2  # 2 DualPathRNNs x 1 SRU layer x 1 repeat
# each DualPathRNN: one pass into K1's layout and one out, around its SRU layers
RNN_OPS = {"sru_stack_layer": SRU_LAYERS, "dual_path_norm_in": 2, "dual_path_out": 2}
AUDIO_ONLY = {**TINY, "video_params": {}, "fusion_params": {}, "video_bn_params": {},
              "pretrained_vout_chan": -1}


def _inputs(seed, n):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, L)).astype(np.float32),
            rng.standard_normal((n, EMB, TV)).astype(np.float32))


def _eager(model, mix, mouth=None):
    with torch.no_grad():
        return model(torch.from_numpy(mix),
                     None if mouth is None else torch.from_numpy(mouth)).numpy()


@pytest.fixture(scope="module")
def tiny():
    """(JAX model, its variables, the port model on the same weights): the
    weights from a seed, perturbed off their constant initial values,
    carried into JAX by ``convert_avnet`` (a shape-only trace) and back into
    the port by ``state_dict_from_jax``."""
    gen = torch.Generator().manual_seed(0)
    model = build_model(TINY, device="cpu", generator=gen)
    sd = {k: (torch.rand(t.shape, generator=gen) + 0.5 if k.endswith("running_var") else
              t + 0.1 * torch.randn(t.shape, generator=gen)) if t.is_floating_point() else t
          for k, t in model.state_dict().items()}
    jm = JaxAVNet(**TINY)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, L)),
                            jnp.zeros((1, EMB, TV)))
    template = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype), shapes)
    v = convert_avnet({k: t.numpy() for k, t in sd.items()}, template, TINY)
    model.load_state_dict(state_dict_from_jax(jax.tree_util.tree_map(np.asarray, v), TINY))
    return jm, v, model.eval()


@pytest.fixture(scope="module")
def cli_artifact(tiny, tmp_path_factory):
    """The CLI's float32 (1, 2)-bucket artifact of the AV model, traced on the
    CPU, and its loaded server."""
    _, _, model = tiny
    d = tmp_path_factory.mktemp("cli")
    ckpt = str(d / "best_model.pth")
    serialization.save_model(ckpt, "AVNet", TINY, model.state_dict())
    out, seconds = export_serving.main([
        "--ckpt", ckpt, "--batch-sizes", "2,1", "--segment", str(L / 16000), "--mouth-shape",
        f"{EMB},{TV}", "--dtype", "float32", "--device", "cpu"])
    assert out == str(d / "model.rtfsx") and sorted(seconds) == [1, 2]
    return E.load_artifact(out)


@pytest.fixture(scope="module")
def audio_only(tmp_path_factory):
    """An audio-only model (the tiny config without its video branch), its
    float32 B=2 program traced on the CPU, and the one-bucket file of it."""
    model = build_model(AUDIO_ONLY, device="cpu", generator=torch.Generator().manual_seed(3))
    program = E.export_serving(model.eval(), 2, L, compute_dtype=torch.float32, device="cpu")
    path = str(tmp_path_factory.mktemp("audio") / "audio.rtfsx")
    E.save_serving(path, program, 2, L, compute_dtype="float32")
    return model, program, path


def test_export_roundtrip_matches_eager_and_jax(tiny, cli_artifact):
    jm, v, model = tiny
    header = cli_artifact.header
    assert header["mouth_shape"] == [EMB, TV] and header["segment_samples"] == L
    assert header["platforms"] == ["cpu"] and header["compute_dtype"] == "float32"
    assert header["calling_convention"] == "separated = f(mix_f32[B, L], mouth_f32[B, *mouth])"
    assert header["model_name"] == "AVNet" and header["sample_rate"] == 16000
    assert header["nr_devices"] == 1 and header["torch_version"] == str(torch.__version__)
    mix, mouth = _inputs(1, 2)
    with torch.inference_mode():
        got = cli_artifact.module(2)(torch.from_numpy(mix), torch.from_numpy(mouth)).numpy()
    assert got.shape == (2, 1, L)
    np.testing.assert_allclose(got, _eager(model, mix, mouth), atol=1e-5, rtol=1e-4)
    want = jax_apply(jm, v, mix, mouth)
    np.testing.assert_allclose(got, want, atol=5e-4 * np.abs(want).max())
    # the model the program was traced from is untouched
    assert all(p.requires_grad for p in model.parameters())


def test_export_audio_only_convention(audio_only):
    model, _, path = audio_only
    program, header = E.load_serving(path)
    assert header["mouth_shape"] is None and header["batch_size"] == 2
    assert header["calling_convention"] == "separated = f(mix_f32[B, L])"
    mix, _ = _inputs(7, 2)
    with torch.inference_mode():
        got = program.module()(torch.from_numpy(mix)).numpy()
    np.testing.assert_allclose(got, _eager(model, mix), atol=1e-5, rtol=1e-4)


def test_export_pins_shapes(cli_artifact):
    mix, mouth = _inputs(2, 3)
    with pytest.raises(Exception), torch.inference_mode():
        cli_artifact.module(2)(torch.from_numpy(mix), torch.from_numpy(mouth))


def test_graph_holds_the_inference_kernel(cli_artifact, audio_only):
    for b in cli_artifact.batch_sizes:
        assert E.op_counts(cli_artifact.program(b)) == RNN_OPS
    assert E.op_counts(audio_only[1]) == RNN_OPS


def test_bucketed_artifact_serves_any_batch(tiny, cli_artifact):
    _, _, model = tiny
    art = cli_artifact
    assert art.batch_sizes == [1, 2] and art.device == torch.device("cpu")
    assert [b["batch_size"] for b in art.header["buckets"]] == [1, 2]
    for n in (1, 2, 3, 5):  # exact fit, pad, and chunk over the largest
        mix, mouth = _inputs(4 + n, n)
        got = art(mix, torch.from_numpy(mouth))
        assert isinstance(got, np.ndarray) and got.shape == (n, 1, L)
        np.testing.assert_allclose(got, _eager(model, mix, mouth), atol=1e-5, rtol=1e-4)
    with pytest.raises(ValueError, match="empty"):
        art(np.zeros((0, L), np.float32), np.zeros((0, EMB, TV), np.float32))
    with pytest.raises(ValueError, match="mismatch"):
        art(*_inputs(3, 2)[:1], _inputs(3, 3)[1])


def test_stencil_op_in_the_graph(audio_only, monkeypatch, tmp_path):
    """With the depthwise convs routed to the stencil op on the CPU (as on
    the card), the program holds its nodes and runs them through the plain
    version."""
    model = audio_only[0]
    monkeypatch.setattr(conv, "DW_KERNEL_DEVICES", ("cuda", "cpu"))
    program = E.export_serving(model, 1, L, compute_dtype=torch.float32, device="cpu")
    counts = E.op_counts(program)
    assert counts.pop("dw_conv2d_same") > 0 and counts == RNN_OPS
    path = str(tmp_path / "dw.rtfsx")
    E.save_serving(path, program, 1, L, compute_dtype="float32")
    mix, _ = _inputs(6, 1)
    got = E.load_artifact(path)(mix)
    np.testing.assert_allclose(got, _eager(model, mix), atol=1e-5, rtol=1e-4)


def test_each_loader_refuses_the_others_file(audio_only, tmp_path):
    _, program, path = audio_only
    with pytest.raises(AssertionError, match="not an rtfs_net_tpu export"):
        jax_read_frame(path)
    for magic in (b"RTFSXPT1", b"RTFSXPT2"):
        jax_file = tmp_path / "jax.rtfsx"
        jax_file.write_bytes(magic + struct.pack("<Q", 2) + b"{}")
        with pytest.raises(ValueError, match="rtfs_net_tpu.export"):
            E.load_artifact(str(jax_file))
    multi = str(tmp_path / "multi.rtfsx")
    E.save_serving_multi(multi, {2: program}, L)
    with pytest.raises(ValueError, match="bucketed"):
        E.load_serving(multi)
    with pytest.raises(ValueError, match="exported for"):
        E.load_artifact(path, device="cuda")
    with open(multi, "ab") as f:
        f.write(b"\0")
    with pytest.raises(ValueError, match="trailing bytes"):
        E.load_artifact(multi)


def test_loading_imports_no_model_code(audio_only):
    path = audio_only[2]
    code = ("import sys, numpy as np\n"
            "from rtfs_net_tpu_torch.export import load_artifact\n"
            f"out = load_artifact({path!r})(np.zeros((1, {L}), np.float32))\n"
            "print(out.shape, sorted(m for m in sys.modules if m.startswith('rtfs_net_tpu_torch.')"
            " and m.split('.')[1] in ('models', 'configs', 'system', 'train')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True).stdout
    assert out.strip() == f"(1, 1, {L}) []"


def test_mesh_devices_raise():
    """A multi-device export is ported (``tests/test_torch_parallel.py``);
    it raises where the batch does not shard evenly over the devices, as
    JAX's does (``tests/test_export.py::test_mesh_export_requires_divisible_batch``)."""
    with pytest.raises(ValueError, match="shard evenly"):
        E.export_serving(torch.nn.Identity(), 3, L, mesh_devices=2, device="cpu")
