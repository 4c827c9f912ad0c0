"""The readers of the LSTM recurrence (``lstm_ms``, ``lstm_roofline``), on
hand-made events of one ``aten::lstm`` call inside its program span."""
import copy
import json
import types

from h100_bench import spec, trace, work

from test_h100_bench_trace import CPU, CUDA, Event

lstm_ms, lstm_roofline = spec.reader("lstm_ms.serve_batch"), spec.reader(
    "lstm_roofline.serve_batch")
# TF-GridNet's intra-frame BLSTM at B=128: 126 windows of 512 over 128·251 rows, H=192
STEPS, ROWS, D_IN, H = 126, 128 * 251, 512, 192


def events(lstm=True):
    shapes = [[STEPS, ROWS, D_IN], [], [], [], [], [], [], [], []]
    return [
        Event(trace.STRETCH, CPU, 0, 1_000_000, annotation=True),
        Event("rtfs.refine.rnn", CPU, 10_000, 900_000, annotation=True),
        Event("rtfs.refine.rnn.recurrence", CPU, 20_000, 800_000, annotation=True),
        Event("aten::lstm" if lstm else "aten::gru", CPU, 30_000, 700_000, corr=5,
              shapes=shapes, dtypes=["c10::BFloat16", "TensorList", "TensorList"]),
        Event("cudaLaunchKernel", CPU, 40_000, 41_000, corr=301, linked=5),
        Event("nvjet_tst_192x192", CUDA, 50_000, 450_000, corr=301, linked=5),
        Event("cudaLaunchKernel", CPU, 42_000, 43_000, corr=302, linked=5),
        Event("elemWiseRNNcell", CUDA, 450_000, 650_000, corr=302, linked=5),
        Event("rtfs.refine.rnn", CUDA, 10_000, 900_000),  # a range's device-side copy
    ]


def cell(name="tfgridnet-serve-b128"):
    return spec.cell(name)


def run_of(evs, served=None):
    return types.SimpleNamespace(trace=trace.Trace(evs, units=1), cell=served or cell(),
                                 traffic={"dtype": "bfloat16"},
                                 window=types.SimpleNamespace(stretch_utterances=128))


def test_lstms_finds_one_layer_lstms_by_their_names():
    weights = 2 * (4 * H * D_IN + 4 * H * H + 2 * 4 * H)
    c = cell()
    assert lstm_roofline.lstms(c.reference, json.dumps(c.conf, sort_keys=True)) == {
        D_IN: (H, 2, weights)}
    rtfs = cell("rtfs4-serve-b128")
    assert lstm_roofline.lstms(rtfs.reference, json.dumps(rtfs.conf, sort_keys=True)) == {}


def test_roofline_is_least_time_over_device_time():
    flops = 2 * 2 * STEPS * ROWS * 4 * H * (D_IN + H)
    weights = 2 * (4 * H * D_IN + 4 * H * H + 2 * 4 * H)
    nbytes = (STEPS * ROWS * D_IN + STEPS * ROWS * 2 * H + weights) * 2
    least = max(flops / work.BF16_FLOPS_PER_S, nbytes / work.HBM_BYTES_PER_S)
    assert least == flops / work.BF16_FLOPS_PER_S  # compute-bound at these shapes
    got = lstm_roofline.read(run_of(events()))
    assert abs(got - 100.0 * least / 600e-6) < 1e-9


def test_recurrence_span_is_read_per_utterance():
    assert abs(lstm_ms.read(run_of(events())) - 1e3 * 600e-6 / 128) < 1e-12


def test_nothing_to_read_reads_none():
    assert lstm_roofline.read(run_of(events(lstm=False))) is None
    wider = copy.deepcopy(cell())
    wider.conf["audionet"]["audio_params"]["layers"]["layer_1"]["kernel_size"] = 5
    wider.conf["audionet"]["audio_params"]["layers"]["layer_2"]["kernel_size"] = 5
    assert lstm_roofline.read(run_of(events(), wider)) is None
    assert lstm_roofline.read(run_of(events(), cell("rtfs4-serve-b128"))) is None
    no_span = [e for e in events() if not e.name().startswith("rtfs.")]
    assert lstm_ms.read(run_of(no_span)) is None
