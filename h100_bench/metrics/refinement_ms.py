"""Device ms per utterance of the kernels launched inside the benchmark's
own range around AVNet's refinement module's forward (forward hooks put it there)."""
from h100_bench.trace import Ranges

MODULE = "avnet.refinement_module"


def install(run):
    from h100_bench.program import stage_modules

    ranges = Ranges({MODULE: stage_modules(run.driver.model, run.driver.video)[MODULE]})
    return ranges.remove


def read(run):
    spans = run.trace.spans(f"h100_bench.{MODULE}")
    if not spans or not run.trace.device:
        return None
    return 1e3 * sum(run.trace.device_s_under(spans)) / run.window.stretch_utterances
