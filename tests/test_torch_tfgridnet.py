"""TF-GridNet in the port (``models/separators/tfgridnet.py``,
``configs/lrs2_TFGridNet_6_layer.yaml``) against the benchmark's plain
reference (``h100_bench/reference/tfgridnet.py``), on the CPU at the tiny
widths of ``h100_bench/tests/tiny_tfgridnet.yaml`` (D=8, H=8, I=4, J=1,
L=2, E=2, 2 blocks). The JAX package has no TF-GridNet; the reference is
what holds the port here. Both get one state dict, drawn by
``h100_bench.weights.make_state`` on the reference's weight rules.

* ``separate`` in float32 against the reference within 1e-5 + 1e-5·|ref|:
  the same operations in another order (the port's fused norms, cuDNN-free
  ``_VF.lstm`` against the reference's step-by-step cell), whose round-off
  at these sizes is under 1e-6 (measured: 4-6e-7 on outputs up to 1.9);
* the port in bfloat16 against the float32 reference within a relative
  error of ``BF16_REL`` per utterance, which the reference itself fails
  with every matmul operand and layer output in fp8;
* the reference's LSTM against ``torch.nn.LSTM`` on the same weights;
* ``rnn_blocks.library_route_calls`` per forward;
* the published YAML at full width on the meta device, port and reference
  alike, and its parameter count;
* one ``System.train_step`` on the tiny config.
"""
import numpy as np
import pytest
import torch
import yaml
from torch import nn

from h100_bench import check, program, spec
from h100_bench.reference import precision
from h100_bench.reference.train import forward
from rtfs_net_tpu_torch.losses import PITLossWrapper, pairwise_neg_sisdr, pairwise_neg_snr
from rtfs_net_tpu_torch.models import build_model, build_video_model
from rtfs_net_tpu_torch.models.layers import rnn_blocks
from rtfs_net_tpu_torch.system import System, make_optimizer
from rtfs_net_tpu_torch.utils.separator import separate

from _torch_port import one_torch_thread  # noqa: F401

CONFIG = "tfgridnet6-av-lrs2"
FILES = spec.reference_files(CONFIG)
REFERENCE = spec.reference(FILES["reference"])
TINY = yaml.safe_load((spec.ROOT / FILES["tiny"]).read_text())
PUBLISHED = yaml.safe_load((spec.ROOT / FILES["published"]).read_text())
SEED = 2 ** 31 + 3
# bfloat16 rounds every operation to 2^-9 relative; a dozen layers deep the
# port reads 0.007-0.010 on four seeds. fp8 (e4m3, 2^-4) reads 0.089-0.134
# on the same seeds. 0.03 is about the geometric mean of the two: three
# times the port's worst, a third of fp8's least.
BF16_REL = 0.03


def _models(conf, seed=SEED):
    """The reference's and the port's (AVNet, video model), one state dict."""
    ref, ref_video = check.reference_models(FILES["reference"], conf, seed, "cpu")
    port, port_video = program.build(conf, "cpu", ref.state_dict(), ref_video.state_dict())
    return ref, ref_video, port, port_video


def _inputs(batch, samples=4000, lip_frames=6, seed=SEED):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(batch, samples, generator=gen) * 0.1, torch.randn(
        batch, 512, lip_frames, generator=gen)


def _rel_err(got, want):
    return (torch.linalg.vector_norm(got.float() - want, dim=-1)
            / torch.linalg.vector_norm(want, dim=-1)).max().item()


def test_separate_matches_the_reference_in_float32():
    """From raw frames through ``separate``: ``separators.get("TFGridNet")``,
    the RefinementModule and ``MaskGenerator(direct=true)``."""
    ref, ref_video, port, port_video = _models(TINY)
    rng = np.random.default_rng(0)
    requests = [(rng.standard_normal((2, 4000)).astype(np.float32) * 0.1,
                 rng.standard_normal((2, 1, 6, 24, 24)).astype(np.float32)) for _ in range(2)]
    want = check.reference_separate(ref, ref_video, requests, 3, "cpu")
    for (mix, frames), w in zip(requests, want):
        got = separate(port, mix, frames, video_model=port_video, device="cpu")
        assert got.shape == (2, 1, 4000)
        np.testing.assert_allclose(got[:, 0], w, atol=1e-5, rtol=1e-5)


def test_bfloat16_port_is_near_and_fp8_reference_is_not():
    ref, _, port, _ = _models(TINY)
    mix, emb = _inputs(3)
    with torch.no_grad():
        want = ref(mix, emb)
        got = port(mix.bfloat16(), emb.bfloat16())[:, 0]
        with precision.mode("fp8"):
            control = forward(ref, mix, emb)
    assert _rel_err(got, want) <= BF16_REL
    assert _rel_err(control, want) > BF16_REL


@pytest.mark.parametrize("bidirectional", [True, False], ids=["bidirectional", "forward"])
def test_reference_lstm_is_nn_lstm(bidirectional):
    """Gate order i, f, g, o, both biases, the reverse direction from the
    last step; 1e-5·(1 + |ref|) allows for the matmuls' other summation
    order."""
    torch.manual_seed(0)
    lstm = nn.LSTM(12, 5, bidirectional=bidirectional)
    ours = REFERENCE.LSTM(12, 5, bidirectional)
    ours.load_state_dict(lstm.state_dict())
    x = torch.randn(9, 4, 12)
    with torch.no_grad():
        want = lstm(x)[0]
        got = ours(x)
    assert got.shape == want.shape == (9, 4, 5 * (2 if bidirectional else 1))
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_library_route_counts_its_calls():
    """Two BLSTM DualPathRNNs a TF-GridNet block; none in RTFS-Net-4's
    serving forward, whose SRU DualPathRNNs take the sequence-layout route."""
    _, _, port, _ = _models(TINY)
    mix, emb = _inputs(1)
    before = rnn_blocks.library_route_calls
    with torch.no_grad():
        port(mix, emb)
    assert rnn_blocks.library_route_calls - before == 2 * TINY["audionet"]["audio_params"][
        "repeats"]
    rtfs = yaml.safe_load((spec.ROOT / spec.reference_files("rtfsnet4-lrs2")["tiny"]).read_text())
    model, video = build_model(rtfs, device="cpu"), build_video_model(rtfs, device="cpu")
    before = rnn_blocks.library_route_calls
    separate(model, mix.numpy(), np.zeros((1, 1, 6, 24, 24), np.float32), video_model=video,
             device="cpu", dtype=torch.bfloat16)
    assert rnn_blocks.library_route_calls == before


def test_published_config_builds_alike_on_meta():
    """D=128, 6 blocks, I=4, J=1, H=192, L=4, E=4, F=129: the same state-dict
    keys and shapes in the port and the reference; 2,674,285 parameters a
    block, 16,165,650 in AVNet."""
    with torch.device("meta"):
        port = build_model(PUBLISHED, device="meta")
        ref, _ = REFERENCE.build(PUBLISHED)
    shapes = [{k: tuple(t.shape) for k, t in m.state_dict().items()} for m in (port, ref)]
    assert shapes[0] == shapes[1]
    blocks = port.refinement_module.audio_net.blocks
    assert len(blocks) == 6
    assert [sum(p.numel() for p in b.parameters()) for b in blocks] == [2674285] * 6
    assert sum(p.numel() for p in port.parameters()) == 16165650
    block = PUBLISHED["audionet"]["audio_params"]["layers"]
    assert [block[k]["layer_type"] for k in sorted(block)] == [
        "DualPathRNN", "DualPathRNN", "MultiHeadSelfAttention2D"]


def test_train_step_reaches_every_lstm():
    """One step on the tiny config from lip embeddings: a finite loss, and a
    finite, nonzero gradient on every block's LSTM weights."""
    model = build_model(TINY, device="cpu", generator=torch.Generator().manual_seed(1))
    system = System(model, make_optimizer(model.parameters(), **TINY["optim"]),
                    {"train": PITLossWrapper(pairwise_neg_snr),
                     "val": PITLossWrapper(pairwise_neg_sisdr)})
    mix, emb = _inputs(2)
    target = torch.randn(2, 1, 4000, generator=torch.Generator().manual_seed(2)) * 0.1
    out = system.train_step((mix, target, emb), torch.Generator().manual_seed(3))
    assert torch.isfinite(out["loss"])
    lstm = [(n, p) for n, p in model.named_parameters() if ".rnn.weight_" in n]
    assert len(lstm) == 2 * 2 * 2 * TINY["audionet"]["audio_params"]["repeats"]
    for name, p in lstm:
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
        assert p.grad.abs().max() > 0, name
