"""Device ms per utterance under the program's ``rtfs.refine.rnn.recurrence``
spans: the LSTM or GRU recurrence of every DualPathRNN on the general
route (PyTorch's own, with its per-call weight casts and zero initial
state). ``rnn_ms`` less this is that route's norm, unfold, layout copies
and overlap-add."""
from h100_bench import spans

install = spans.install


def read(run):
    return spans.device_ms_per_utt(run, "rtfs.refine.rnn.recurrence")
