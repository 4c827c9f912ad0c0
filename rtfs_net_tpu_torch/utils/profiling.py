"""Timing and tracing on the card (``rtfs_net_tpu/utils/profiling.py``):
``timed`` with CUDA events and a distinct input for every call,
``device_memory_stats`` and a ``torch.profiler`` ``trace``."""
from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, Optional

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """``torch.profiler`` over the block (the card's kernels too, where
    there is one); writes a Chrome trace that TensorBoard or Perfetto open
    into ``logdir``."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)):
        yield


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
