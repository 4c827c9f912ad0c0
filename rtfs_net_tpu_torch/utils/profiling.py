"""Timing and tracing on the card (``rtfs_net_tpu/utils/profiling.py``):
``timed`` with CUDA events and a distinct input for every call,
``device_memory_stats``, a ``torch.profiler`` ``trace`` and the program's
own spans.

``span(name)`` marks a stage of the program as a ``record_function``
range, on the profiler's timeline beside the kernels it launches. Spans
are off unless switched on (``switch_spans_on``); off, ``span`` reads one
module flag and returns a shared no-op context, and nothing calls
``record_function``. An operator sees the program's stages beside the
kernels in Perfetto or TensorBoard with::

    from rtfs_net_tpu_torch.utils import profiling
    with profiling.trace("traces/"):
        separate(model, mix, frames, video_model=video)

``trace`` switches spans on for its block. The serving path's spans are
named ``rtfs.*``, from ``rtfs.separate`` (one request; its args give the
batch) down to the refinement's sub-stages. No span nests in a span of its
own name: readers of a trace add up the device time under each span.
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, Optional

import torch

# how many switches are on; a count, so that undoing several switches in
# any order leaves spans off once every one is undone
_spans_on = 0
_OFF = contextlib.nullcontext()


def switch_spans_on() -> Callable[[], None]:
    """Switch the program's spans on; returns the undo of this switch
    (calling it again does nothing)."""
    global _spans_on
    _spans_on += 1
    undone = False

    def undo():
        global _spans_on
        nonlocal undone
        if not undone:
            undone = True
            _spans_on -= 1

    return undo


def span(name: str, args: Optional[str] = None):
    """A ``record_function(name, args)`` range while spans are on, else a
    shared no-op context. Under ``torch.compile`` or ``torch.export`` it is
    the no-op too, so that a traced graph holds no profiler ops."""
    if not _spans_on or torch.compiler.is_compiling() or torch.compiler.is_exporting():
        return _OFF
    from torch.profiler import record_function

    return record_function(name, args)


@contextlib.contextmanager
def trace(logdir: str):
    """``torch.profiler`` over the block (the card's kernels too, where
    there is one), with the program's spans on; writes a Chrome trace that
    TensorBoard or Perfetto open into ``logdir``."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    undo = switch_spans_on()
    try:
        with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)):
            yield
    finally:
        undo()


def timed(fn: Callable, make_args: Callable[[int], tuple], iters: int = 4,
          warmup: int = 1) -> Dict[str, float]:
    """Milliseconds per call of ``fn``: min and mean over ``iters`` calls.

    ``make_args(i)`` returns the arguments of call ``i`` (warm-up calls get
    i = -1, -2, ...), distinct for each i, so that no call reuses another's
    inputs or their cached results. A call whose arguments lie on a card is
    timed by two CUDA events around it (the card's time from its first
    work to its last), read after a synchronise; any other by the host
    clock.
    """
    for i in range(warmup):
        fn(*make_args(-1 - i))
    times = []
    for i in range(iters):
        args = make_args(i)
        if any(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn(*args)
            times.append((time.perf_counter() - t0) * 1e3)
    return {"min_ms": min(times), "mean_ms": sum(times) / len(times)}


def device_memory_stats() -> Optional[Dict]:
    """The card's allocator statistics (``torch.cuda.memory_stats``), or
    None without a card."""
    return torch.cuda.memory_stats() if torch.cuda.is_available() else None
