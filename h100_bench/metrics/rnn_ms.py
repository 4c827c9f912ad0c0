"""Device ms per utterance under the program's ``rtfs.refine.rnn`` spans:
every DualPathRNN, K1 and the unfold, norm and ConvTranspose1d around it."""
from h100_bench import spans

install = spans.install


def read(run):
    return spans.device_ms_per_utt(run, "rtfs.refine.rnn")
