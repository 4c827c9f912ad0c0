"""TF-GridNet at its published widths on an NVIDIA card
(``rtfs_net_tpu_torch/configs/lrs2_TFGridNet_6_layer.yaml``): the port's
bfloat16 ``separate`` from raw frames against the benchmark's float32
plain reference (``h100_bench/reference/tfgridnet.py``), the
DualPathRNN's window-layout route's counters and its recurrence span.

Marked ``card``; each test skips without a card (``tests/_torch_card.py``).
Neither this file nor what it imports loads JAX, so it runs on a machine
without it::

    python3 -m pytest --noconftest -p no:cacheprovider -m card tests/test_torch_card_tfgridnet.py

The bfloat16 result is held to the benchmark cell's own limit
(``h100_bench/limits/tfgridnet-serve-b128.json``): the worst utterance's
‖program − reference‖ / ‖reference‖, set above the geometric mean of the
program's worst and the fp8 control's least over the calibration seeds.
"""
import collections
import json

import numpy as np
import pytest
import torch
import yaml

from h100_bench import check, program, spec, trace
from rtfs_net_tpu_torch.models.layers import rnn_blocks
from rtfs_net_tpu_torch.utils import profiling
from rtfs_net_tpu_torch.utils.separator import separate

from _torch_card import card  # noqa: F401

pytestmark = pytest.mark.card

CONFIG, CELL = "tfgridnet6-av-lrs2", "tfgridnet-serve-b128"
FILES = spec.reference_files(CONFIG)
PUBLISHED = yaml.safe_load((spec.ROOT / FILES["published"]).read_text())
LIMIT = json.loads((spec.HERE / "limits" / f"{CELL}.json").read_text())["max_rel_err"]
SEED = 2 ** 31 + 21
B = 2


@pytest.fixture(scope="module")
def served(card):
    """The port's models with the reference's seeded weights, on the card,
    and one request of B two-second clips with 50 frames of 88x88."""
    ref, ref_video = check.reference_models(FILES["reference"], PUBLISHED, SEED, "cuda")
    port, port_video = program.build(PUBLISHED, "cuda", ref.state_dict(), ref_video.state_dict())
    rng = np.random.default_rng(SEED)
    mix = (rng.standard_normal((B, 32000)) * 0.1).astype(np.float32)
    frames = rng.standard_normal((B, 1, 50, 88, 88)).astype(np.float32)
    return ref, ref_video, port, port_video, mix, frames


def test_bfloat16_separate_is_within_the_cell_limit(served):
    ref, ref_video, port, port_video, mix, frames = served
    with check.exact_float32():
        (want,) = check.reference_separate(ref, ref_video, [(mix, frames)], B, "cuda")
    got = separate(port, mix, frames, video_model=port_video, dtype=torch.bfloat16)
    err = np.linalg.norm(got[:, 0] - want, axis=-1) / np.linalg.norm(want, axis=-1)
    print(f"max_rel_err {float(err.max())!r} (limit {LIMIT})")
    assert got.shape == (B, 1, 32000) and float(err.max()) <= LIMIT


def test_twelve_library_route_calls_a_forward(served):
    _, _, port, port_video, mix, frames = served
    before = rnn_blocks.library_route_calls
    separate(port, mix, frames, video_model=port_video, dtype=torch.bfloat16)
    assert rnn_blocks.library_route_calls - before == 12


def test_twelve_window_layout_calls_a_forward(served):
    """Every BLSTM DualPathRNN of the six blocks takes the window-layout
    route (its launches, one of ``dual_path_windows_in`` each, are held in
    ``tests/test_torch_card_paths.py``)."""
    _, _, port, port_video, mix, frames = served
    calls = rnn_blocks.window_layout_calls
    separate(port, mix, frames, video_model=port_video, dtype=torch.bfloat16)
    assert rnn_blocks.window_layout_calls - calls == 12


def test_recurrence_span_holds_the_lstm(served):
    """With spans on, 12 ``rtfs.refine.rnn.recurrence`` ranges a request,
    each inside an ``rtfs.refine.rnn`` and around one ``aten::lstm`` (host
    events; the profiler's device-side copies of the ranges are left out);
    prints the kernels launched under ``aten::lstm``, by device time, none
    of which is PyTorch's strided copy: the windows reach cuDNN contiguous."""
    _, _, port, port_video, mix, frames = served
    undo = profiling.switch_spans_on()
    holder = {}
    try:
        with trace.profiled(holder, host=True):
            separate(port, mix, frames, video_model=port_video, dtype=torch.bfloat16)
    finally:
        undo()
    t = trace.Trace(holder["events"], 1)
    spans, lstms = t.spans("rtfs.refine.rnn.recurrence"), t.spans("aten::lstm")
    assert len(spans) == len(lstms) == 12 and len(t.spans("rtfs.refine.rnn")) == 12
    for span, lstm in zip(spans, lstms):
        assert span.start <= lstm.start and lstm.end <= span.end
    kernels = collections.Counter()
    for name, s, e, thread, at in t.device:
        if at is not None and any(h.thread == thread and h.start <= at <= h.end for h in lstms):
            kernels[name] += (e - s) / 1e6
    assert kernels
    for name, ms in kernels.most_common(12):
        print(f"kernel {ms:.3f} ms {name[:140]}")
    assert not [name for name in kernels if "direct_copy" in name]
