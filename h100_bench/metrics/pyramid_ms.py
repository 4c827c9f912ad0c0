"""Device ms per utterance under the program's ``rtfs.refine.pyramid``
spans: each refinement block's gateway, projection and downsampling convs
(and TDANet's pooled sum)."""
from h100_bench import spans

install = spans.install


def read(run):
    return spans.device_ms_per_utt(run, "rtfs.refine.pyramid")
