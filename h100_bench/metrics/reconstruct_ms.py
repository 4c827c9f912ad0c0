"""Device ms per utterance under the program's ``rtfs.refine.reconstruct``
spans: each refinement block's way back up (injection sums or lateral
convs and interpolations, concat merges, the residual conv)."""
from h100_bench import spans

install = spans.install


def read(run):
    return spans.device_ms_per_utt(run, "rtfs.refine.reconstruct")
