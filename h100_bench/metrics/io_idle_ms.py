"""Device-idle ms per utterance of the traced stretch with host operators,
in the gaps that began with ``rtfs.separate``, its upload or its download
as the innermost ``rtfs.*`` span, or between requests: the idle time the
model's forwards (``rtfs.video``, ``rtfs.avnet``) do not hold. That
stretch's profiler slows the host, so this reads somewhat above the idle
time of an untraced run."""
from h100_bench import spans

install = spans.install
IO = ("rtfs.separate", "rtfs.separate.upload", "rtfs.separate.download", spans.BETWEEN)


def read(run):
    t = run.trace
    if not t.spans("rtfs.separate") or not t.device:
        return None
    gaps = spans.idle_s_by_span(t)
    return 1e3 * sum(gaps.get(name, 0.0) for name in IO) / run.window.stretch_utterances
