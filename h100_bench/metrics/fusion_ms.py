"""Device ms per utterance under the program's ``rtfs.fusion`` spans: each
cross-modal fusion block of the refinement."""
from h100_bench import spans

install = spans.install


def read(run):
    return spans.device_ms_per_utt(run, "rtfs.fusion")
