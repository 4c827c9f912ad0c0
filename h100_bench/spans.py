"""The program's own spans (``rtfs_net_tpu_torch/utils/profiling.py``:
``record_function`` ranges named ``rtfs.*``, off unless switched on), read
from the traced stretch with host operators. Readers switch them on for
that stretch alone (``install``), so the window and the device-only
stretch run the program as it is served. A program without the switch
records no span, and every reader of a span then reads nothing."""
from __future__ import annotations

import collections
import copy
from typing import Callable, Dict, Optional

# the idle gaps that begin with no span of the prefix open
BETWEEN = "between requests"


def install(run) -> Callable[[], None]:
    """Switch the program's spans on; returns the undo."""
    from rtfs_net_tpu_torch.utils import profiling

    switch = getattr(profiling, "switch_spans_on", None)
    return switch() if switch is not None else (lambda: None)


def device_ms_per_utt(run, name: str) -> Optional[float]:
    """Device ms per utterance of the work launched inside every span
    ``name`` of the traced stretch."""
    spans = run.trace.spans(name)
    if not spans or not run.trace.device:
        return None
    return 1e3 * sum(run.trace.device_s_under(spans)) / run.window.stretch_utterances


def idle_s_by_span(trace, prefix: str = "rtfs.") -> Dict[str, float]:
    """The device's idle seconds in the traced stretch, every gap put down to
    the innermost span whose name starts with ``prefix`` open on the main
    thread when the gap began (``BETWEEN`` where none was)."""
    spans = copy.copy(trace)
    spans.host = [h for h in trace.host if h.name.startswith(prefix)]
    gaps = collections.Counter(dict(spans.idle_gaps(top=None, least_ns=0)))
    gaps[BETWEEN] += gaps.pop("host (between operators)", 0.0)
    return dict(gaps)
