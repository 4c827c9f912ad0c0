"""The readers of the program's spans, on hand-made events of one request,
and the switch in a traced run of a tiny cell on the CPU."""
import time
import types

import pytest

from h100_bench import drive, run, spans, spec, trace

from _tiny import tiny_cell
from test_h100_bench_trace import CPU, CUDA, Event
from test_h100_bench_trace import events as events_without_spans

UTTERANCES = 2


def request():
    """One request of the stretch, times in ns. The device runs the upload's
    copy, one kernel in each refinement sub-stage and the download's copy,
    and idles between them."""
    launched = []

    def under(span, start, end, kernel, k_start, k_end, corr, call="cudaLaunchKernel"):
        launched.extend([
            Event(span, CPU, start, end, annotation=True),
            Event(call, CPU, start + 1_000, start + 1_500, corr=corr),
            Event(kernel, CUDA, k_start, k_end, corr=corr)])

    under("rtfs.separate.upload", 2_000, 40_000, "Memcpy HtoD (Pageable -> Device)", 20_000,
          30_000, 201, "cudaMemcpyAsync")
    under("rtfs.refine.pyramid", 55_000, 80_000, "conv_depthwise2d_forward", 58_000, 70_000, 202)
    under("rtfs.refine.rnn", 85_000, 110_000, "sru_stack_layer_ring_kernel", 88_000, 100_000,
          203)
    under("rtfs.refine.attention", 110_000, 120_000, "softmax_kernel", 112_000, 118_000, 204)
    under("rtfs.refine.reconstruct", 120_000, 130_000, "CatArrayBatchedCopy", 122_000,
          128_000, 205)
    under("rtfs.fusion", 130_000, 138_000, "elementwise_kernel", 132_000, 136_000, 206)
    under("rtfs.separate.download", 160_000, 185_000, "Memcpy DtoH (Device -> Pageable)",
          170_000, 175_000, 207, "cudaMemcpyAsync")
    return [
        Event(trace.STRETCH, CPU, 0, 200_000, annotation=True),
        Event("rtfs.separate", CPU, 1_000, 190_000, annotation=True),
        Event("aten::copy_", CPU, 3_000, 39_000),
        Event("rtfs.avnet", CPU, 45_000, 150_000, annotation=True),
        Event("rtfs.refinement", CPU, 50_000, 140_000, annotation=True),
        Event("rtfs.refinement", CUDA, 50_000, 140_000),  # the range's device-side copy
        Event("aten::copy_", CPU, 161_000, 184_000),
    ] + launched


def fake_run(events):
    return types.SimpleNamespace(trace=trace.Trace(events, units=1),
                                 window=types.SimpleNamespace(stretch_utterances=UTTERANCES))


# reader -> device seconds of the request under its span
UNDER = {"upload_ms": 10e-6, "pyramid_ms": 12e-6, "rnn_ms": 12e-6, "attention_ms": 6e-6,
         "reconstruct_ms": 6e-6, "fusion_ms": 4e-6}


@pytest.mark.parametrize("metric", sorted(UNDER))
def test_device_ms_under_each_span(metric):
    got = spec.reader(f"{metric}.serve_batch").read(fake_run(request()))
    assert got == pytest.approx(1e3 * UNDER[metric] / UTTERANCES, rel=1e-12)


def test_idle_gaps_go_to_the_innermost_span():
    t = fake_run(request()).trace
    gaps = spans.idle_s_by_span(t)
    # the device idles 0-20 us (no span open yet), 30-58 (the upload's
    # aten::copy_ open, inside the upload span), 70-88 (pyramid), 100-112
    # (rnn), 118-122 (attention), 128-132 (reconstruct), 136-170 (fusion)
    # and 175-200 us (download)
    want = {spans.BETWEEN: 20e-6, "rtfs.separate.upload": 28e-6, "rtfs.refine.pyramid": 18e-6,
            "rtfs.refine.rnn": 12e-6, "rtfs.refine.attention": 4e-6,
            "rtfs.refine.reconstruct": 4e-6, "rtfs.fusion": 34e-6,
            "rtfs.separate.download": 25e-6}
    assert set(gaps) == set(want)
    assert all(gaps[k] == pytest.approx(v, rel=1e-12) for k, v in want.items())
    # the operators' view of the same gap names the op, not the span
    assert dict(t.idle_gaps(least_ns=1))["aten::copy_"] == pytest.approx(28e-6 + 25e-6)
    io = spec.reader("io_idle_ms.serve_batch").read(fake_run(request()))
    assert io == pytest.approx(1e3 * (20e-6 + 28e-6 + 25e-6) / UTTERANCES, rel=1e-12)


def test_a_program_without_spans_reads_nothing(monkeypatch):
    from rtfs_net_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "switch_spans_on")
    spans.install(None)()
    for metric in ("io_idle_ms", *UNDER):
        assert spec.reader(f"{metric}.serve_batch").read(fake_run(events_without_spans())) is None


def test_the_traced_stretch_alone_has_spans(monkeypatch):
    """A traced run on the CPU: the program's spans appear in the stretch
    with host operators, and not in the device-only stretch, and are off
    once the run is over."""
    from rtfs_net_tpu_torch.utils import profiling

    stretches = []
    stretch = drive.stretch

    def kept(driver, units, first, install, w):
        stretch(driver, units, first, install, w)
        stretches.append(w)

    monkeypatch.setattr(drive, "stretch", kept)
    cell = tiny_cell("rtfs4-serve-b128", dtype="float32")
    out = run.run_cell(cell, 2 ** 31 + 13, 0.1, True, "cpu", time.time())
    assert out["correct"]
    w = stretches[0]
    names = {h.name for h in w.stretch.host if h.name.startswith("rtfs.")}
    assert {"rtfs.separate", "rtfs.separate.upload", "rtfs.refine.rnn", "rtfs.fusion"} <= names
    assert not any(h.name.startswith("rtfs.") for h in w.light.host)
    assert profiling.span("x") is profiling.span("y")  # off again
