"""Device ms per utterance of the work launched inside the program's
``rtfs.separate.upload`` span: the mixture's and the frames' copies to the
card (pageable host memory) and their casts."""
from h100_bench import spans

install = spans.install


def read(run):
    return spans.device_ms_per_utt(run, "rtfs.separate.upload")
