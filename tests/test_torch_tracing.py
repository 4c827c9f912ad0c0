"""The program's spans (``rtfs_net_tpu_torch/utils/profiling.py``) on the
serving path, on the CPU at tiny widths with the FRCNN video model: off,
``separate`` records no ``rtfs.*`` event and never enters
``record_function``; on, every span of the path appears on one thread,
nested as the program runs it; the switch counts; ``profiling.trace``
switches spans on for its block alone; an export with spans on gives the
graph of one with spans off."""
import contextlib
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ExecutionTraceObserver, ProfilerActivity, profile

from rtfs_net_tpu_torch import export
from rtfs_net_tpu_torch.models import build_model, build_video_model
from rtfs_net_tpu_torch.utils import profiling
from rtfs_net_tpu_torch.utils.separator import separate

from _torch_port import one_torch_thread  # noqa: F401
from test_torch_avnet import TINY as RTFS_TINY
from test_torch_ctcnet import TINY as CTC_TINY

VIDEO = {"model_name": "FRCNNVideoModel", "backbone_type": "resnet", "relu_type": "prelu",
         "width_mult": 1.0}
CONFIGS = {"rtfs": {**RTFS_TINY, "pretrained_vout_chan": 512},
           "ctcnet": {**CTC_TINY, "pretrained_vout_chan": 512}}
B, SAMPLES, FRAMES, SIDE = 2, 4000, 6, 24

# each span -> the span it opens in
PARENT = {
    "rtfs.separate": None,
    "rtfs.separate.upload": "rtfs.separate",
    "rtfs.video": "rtfs.separate",
    "rtfs.avnet": "rtfs.separate",
    "rtfs.separate.download": "rtfs.separate",
    "rtfs.refinement": "rtfs.avnet",
    "rtfs.refine.pyramid": "rtfs.refinement",
    "rtfs.refine.rnn": "rtfs.refinement",
    "rtfs.refine.attention": "rtfs.refinement",
    "rtfs.refine.reconstruct": "rtfs.refinement",
    "rtfs.fusion": "rtfs.refinement",
}
# spans a request opens: RTFS-Net's 2 audio blocks (two DualPathRNNs and
# MHSA2D each) and 1 video block (GlobalAttention) around 1 fusion;
# CTCNet's 3 audio and 2 video FRCNN blocks around 2 fusions
COUNTS = {
    "rtfs": {"rtfs.refine.pyramid": 3, "rtfs.refine.rnn": 4, "rtfs.refine.attention": 3,
             "rtfs.refine.reconstruct": 3, "rtfs.fusion": 1},
    "ctcnet": {"rtfs.refine.pyramid": 5, "rtfs.refine.reconstruct": 5, "rtfs.fusion": 2},
}


@pytest.fixture(scope="module")
def served():
    """name -> (model, video model, mixtures, frames)."""
    rng = np.random.default_rng(0)
    video = build_video_model(VIDEO, device="cpu")
    return {name: (build_model(conf, device="cpu"), video,
                   rng.standard_normal((B, SAMPLES)).astype(np.float32),
                   rng.standard_normal((B, 1, FRAMES, SIDE, SIDE)).astype(np.float32))
            for name, conf in CONFIGS.items()}


def _serve(served, name):
    model, video, mix, frames = served[name]
    return separate(model, mix, frames, video_model=video, device="cpu")


def _profiled(served, name, record_shapes=False):
    with profile(activities=[ProfilerActivity.CPU], record_shapes=record_shapes) as prof:
        out = _serve(served, name)
    spans = [e for e in prof.profiler.kineto_results.events() if e.name().startswith("rtfs.")]
    return out, spans


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_spans_off_record_nothing(served, name, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with spans off")

    with monkeypatch.context() as m:
        m.setattr(torch.profiler, "record_function", refuse)
        m.setattr(torch.autograd.profiler, "record_function", refuse)
        _serve(served, name)
    _, spans = _profiled(served, name)
    assert spans == []


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_spans_on_nest_as_the_program_runs(served, name, tmp_path):
    want = _serve(served, name)
    undo = profiling.switch_spans_on()
    try:
        got, spans = _profiled(served, name, record_shapes=True)
        et = ExecutionTraceObserver().register_callback(str(tmp_path / "et.json"))
        et.start()
        try:
            _serve(served, name)
        finally:
            et.stop()
            et.unregister_callback()
    finally:
        undo()
    np.testing.assert_array_equal(got, want)

    assert len({e.start_thread_id() for e in spans}) == 1
    stack, parent = [], {}
    for e in sorted(spans, key=lambda e: (e.start_ns(), -e.end_ns())):
        while stack and stack[-1].end_ns() <= e.start_ns():
            stack.pop()
        assert all(e.end_ns() <= s.end_ns() for s in stack)
        parent.setdefault(e.name(), set()).add(stack[-1].name() if stack else None)
        stack.append(e)
    names = set(PARENT) - ({"rtfs.refine.rnn", "rtfs.refine.attention"}
                           if name == "ctcnet" else set())
    assert set(parent) == names
    # nested as listed, and so never inside a span of its own name
    assert all(parent[n] == {PARENT[n]} for n in names)
    counts = {n: sum(e.name() == n for e in spans) for n in names}
    assert counts == {**{n: 1 for n in names}, **COUNTS[name]}

    # the request's args: one argument on the profiler's event (which keeps
    # no string's text), the batch in the execution trace
    root = next(e for e in spans if e.name() == "rtfs.separate")
    assert len(root.shapes()) == 1
    nodes = json.loads((tmp_path / "et.json").read_text())["nodes"]
    assert [n["inputs"]["values"] for n in nodes if n["name"] == "rtfs.separate"] == [
        [f"batch={B}"]]


def test_the_switch_counts():
    assert profiling.span("a") is profiling.span("b")  # the shared no-op: off
    first, second = profiling.switch_spans_on(), profiling.switch_spans_on()
    first()  # undone in install order, not in reverse
    assert isinstance(profiling.span("a"), torch.profiler.record_function)
    second()
    assert profiling.span("a") is profiling._OFF
    first()  # a second call of an undo does nothing
    undo = profiling.switch_spans_on()
    assert isinstance(profiling.span("a", "x=1"), torch.profiler.record_function)
    assert profiling.span("a", "x=1").args == "x=1"
    undo()
    assert profiling.span("a") is profiling._OFF


@pytest.mark.parametrize("already_on", [False, True])
def test_trace_writes_the_spans_and_restores_the_switch(served, tmp_path, already_on):
    undo = profiling.switch_spans_on() if already_on else (lambda: None)
    try:
        with profiling.trace(str(tmp_path)):
            _serve(served, "rtfs")
        assert (profiling.span("a") is profiling._OFF) is not already_on
    finally:
        undo()
    assert profiling.span("a") is profiling._OFF
    files = [f for f in os.listdir(tmp_path) if f.endswith(".json")]
    assert len(files) == 1
    events = json.loads((tmp_path / files[0]).read_text())["traceEvents"]
    assert set(PARENT) <= {e.get("name") for e in events}


def test_export_sees_no_span(monkeypatch):
    # one audio block: every span of the refinement, half the graph to trace
    conf = {**CONFIGS["rtfs"], "audio_params": {**RTFS_TINY["audio_params"], "repeats": 1}}
    model = build_model(conf, device="cpu")

    def graph():
        program = export.export_serving(model, 1, SAMPLES, (512, FRAMES), torch.float32,
                                        device="cpu")
        return str(program.graph)

    off = graph()
    entered = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda *args: entered.append(args) or contextlib.nullcontext())
    undo = profiling.switch_spans_on()
    try:
        on = graph()
    finally:
        undo()
    assert on == off and entered == []
