"""Device ms per utterance under the program's ``rtfs.refine.attention``
spans: the audio blocks' MHSA2D and the video block's GlobalAttention."""
from h100_bench import spans

install = spans.install


def read(run):
    return spans.device_ms_per_utt(run, "rtfs.refine.attention")
