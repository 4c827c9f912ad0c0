"""The traced stretch: ``torch.profiler`` over a few calls of the window's
own loop, reduced to what the per-layer readers take.

The profiler's raw events (Kineto's) are read once: device events (kernels,
copies, sets) as intervals on the device; host events as intervals per
thread (operators, ranges, and the CUDA runtime and driver calls). Each
device event is tied to the host thread and time of the runtime call that
launched it, by correlation id, so that a kernel belongs to every operator
or range that was open on that thread at its launch, whatever the kernel's
name.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import re
from typing import Dict, Iterable, List, Optional, Tuple

import torch

STRETCH = "h100_bench.stretch"
# CUDA runtime and driver calls that put work on the device
LAUNCH_CALLS = re.compile(
    r"^(cuda|cu)(LaunchKernel(ExC|Ex)?|LaunchCooperativeKernel|GraphLaunch|MemcpyAsync|"
    r"Memcpy2DAsync|MemsetAsync|MemcpyHtoDAsync|MemcpyDtoHAsync|MemcpyDtoDAsync|"
    r"MemsetD8Async|MemsetD32Async)(_v\d+)?(_ptsz)?$")
RUNTIME = re.compile(r"^(cuda|cu)[A-Z]")
# kernel name regexes, first match wins (the port's chip_smoke.py
# PROFILE_CATEGORIES, copied)
CATEGORIES = [
    ("sru_kernel", r"sru_stack_layer"),
    ("sru_train_kernel", r"sru_train"),
    ("sru_direction_kernel", r"sru_direction"),
    ("dw_conv_kernel", r"dw_conv_(band|generic)"),
    ("fft", r"fft"),
    ("softmax", r"softmax"),
    ("norm_reduce", r"norm|reduce|welford|moments"),
    ("matmul", r"gemm|cutlass|xmma_gemm|sm90_xmma|cublas"),
    ("conv", r"conv|cudnn|implicit|winograd|dgrad|wgrad|xmma|depthwise"),
    ("copy_layout", r"copy|cat|transpose|permute|pad|upsample|index|gather|scatter"),
    ("elementwise", r"elementwise|vectorized|unrolled|prelu|sigmoid|relu|add|mul"),
]


def category(name: str) -> str:
    low = name.lower()
    return next((cat for cat, pattern in CATEGORIES if re.search(pattern, low)), "other")


def _end(e) -> int:
    end = getattr(e, "end_ns", None)
    return end() if end is not None else e.start_ns() + e.duration_ns()


class HostEvent:
    __slots__ = ("name", "thread", "start", "end", "shapes", "dtypes", "corr")

    def __init__(self, e):
        self.name, self.thread = e.name(), e.start_thread_id()
        self.start, self.end = e.start_ns(), _end(e)
        self.corr = e.correlation_id()
        self.shapes, self.dtypes = e.shapes(), e.dtypes()


class Trace:
    """The reduced events of one traced stretch (times in ns)."""

    def __init__(self, kineto_events: Iterable, units: int, wall_s: Optional[float] = None):
        self.units = units  # requests or steps in the stretch
        host, device, annotations = [], [], set()
        for e in kineto_events:
            if e.device_type() == torch.autograd.DeviceType.CPU:
                h = HostEvent(e)
                host.append(h)
                if getattr(e, "is_user_annotation", lambda: False)():
                    annotations.add(h.name)
            elif e.device_type() == torch.autograd.DeviceType.CUDA:
                device.append((e.name(), e.start_ns(), _end(e), e.correlation_id(),
                               e.linked_correlation_id()))
        stretch = [h for h in host if h.name == STRETCH]
        if stretch:
            stretch = max(stretch, key=lambda h: h.end - h.start)
            self.start, self.end, self.main = stretch.start, stretch.end, stretch.thread
        else:  # a trace of device activity alone: all of it is the stretch's
            self.start = min([h.start for h in host] + [d[1] for d in device])
            self.end = max([h.end for h in host] + [d[2] for d in device])
            self.main = None
        self._wall_s = wall_s
        self.host = [h for h in host if h.end >= self.start and h.start <= self.end]
        launches = {h.corr: h for h in self.host if RUNTIME.match(h.name)}
        ops = {h.corr: h for h in self.host if not RUNTIME.match(h.name)}
        self.launch_calls = sum(1 for h in self.host if LAUNCH_CALLS.match(h.name))
        # device work, without the profiler's device-side copies of host
        # ranges (which carry the range's name)
        names = annotations | {h.name for h in host}
        self.device = []  # (name, start, end, launching thread, launch time)
        for name, s, t, corr, linked in device:
            if name in names or t < self.start or s > self.end:
                continue
            call = launches.get(corr) or ops.get(linked)
            self.device.append((name, max(s, self.start), min(t, self.end),
                                call.thread if call else None, call.start if call else None))

    # ------------------------------------------------------------ device
    @property
    def wall_s(self) -> float:
        return self._wall_s if self._wall_s is not None else (self.end - self.start) / 1e9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        merged = []
        for _, s, t, _, _ in sorted(self.device, key=lambda d: d[1]):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t)
            else:
                merged.append([s, t])
        return [(s, t) for s, t in merged]

    @property
    def busy_s(self) -> float:
        return sum(t - s for s, t in self.busy_intervals()) / 1e9

    def by_kernel(self) -> collections.Counter:
        totals = collections.Counter()
        for name, s, t, _, _ in self.device:
            totals[name] += (t - s) / 1e9
        return totals

    def by_category(self) -> collections.Counter:
        totals = collections.Counter()
        for name, sec in self.by_kernel().items():
            totals[category(name)] += sec
        return totals

    # ---------------------------------------------- host ranges and ops
    def spans(self, name: str) -> List[HostEvent]:
        return sorted((h for h in self.host if h.name == name), key=lambda h: h.start)

    def device_s_under(self, spans: List[HostEvent]) -> List[float]:
        """Device seconds of the work launched inside each of ``spans``
        (intervals that do not overlap on a thread)."""
        per = [0.0] * len(spans)
        by_thread: Dict[int, List[Tuple[int, int, int]]] = collections.defaultdict(list)
        for i, h in enumerate(spans):
            by_thread[h.thread].append((h.start, h.end, i))
        starts = {th: [s for s, _, _ in v] for th, v in by_thread.items()}
        for _, s, t, thread, at in self.device:
            if thread not in by_thread:
                continue
            k = bisect.bisect_right(starts[thread], at) - 1
            if k >= 0:
                start, end, i = by_thread[thread][k]
                if at <= end:
                    per[i] += (t - s) / 1e9
        return per

    def idle_gaps(self, top: int = 10, least_ns: int = 2000) -> List[Tuple[str, float]]:
        """Idle time on the device, by the innermost operator or range open
        on the main thread when each gap began."""
        busy = self.busy_intervals()
        edges = [self.start] + [x for iv in busy for x in iv] + [self.end]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] - edges[i] >= least_ns]
        spans = sorted((h for h in self.host if h.thread == self.main and h.name != STRETCH
                        and not RUNTIME.match(h.name)), key=lambda h: (h.start, -h.end))
        totals = collections.Counter()
        stack, j = [], 0
        for s, t in sorted(gaps):
            while j < len(spans) and spans[j].start <= s:
                while stack and stack[-1].end < spans[j].start:
                    stack.pop()
                stack.append(spans[j])
                j += 1
            while stack and stack[-1].end < s:
                stack.pop()
            totals[stack[-1].name if stack else "host (between operators)"] += (t - s) / 1e9
        return totals.most_common(top)


@contextlib.contextmanager
def profiled(holder: Dict, host: bool):
    """Profile the block; the raw events land in ``holder["events"]``. With
    ``host`` the profiler records the host's operators and ranges with
    their input shapes too; without, only the device's work and the CUDA
    runtime and driver calls (far less overhead on a host-bound path), and
    ``holder["wall_s"]`` is the block's wall by the host clock, from a
    synchronised start to a synchronised end."""
    import time

    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.cuda.is_available()
    activities = ([ProfilerActivity.CPU] if host or not cuda else []) + (
        [ProfilerActivity.CUDA] if cuda else [])
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    with profile(activities=activities, record_shapes=host) as prof:
        sync()
        t0 = time.perf_counter()
        with record_function(STRETCH) if host else contextlib.nullcontext():
            yield
            sync()
        holder["wall_s"] = time.perf_counter() - t0
    holder["events"] = prof.profiler.kineto_results.events()


class Ranges:
    """``record_function`` ranges around modules, entered by forward
    pre-hooks and left by forward hooks; ``remove`` takes the hooks off."""

    def __init__(self, modules: Dict[str, torch.nn.Module]):
        from torch.profiler import record_function

        self.handles, self.open = [], {}

        for name, module in modules.items():
            def enter(_m, _args, name=name):
                self.open[name] = record_function(f"h100_bench.{name}")
                self.open[name].__enter__()

            def leave(_m, _args, _out, name=name):
                self.open.pop(name).__exit__(None, None, None)

            self.handles += [module.register_forward_pre_hook(enter),
                             module.register_forward_hook(leave)]

    def remove(self):
        for h in self.handles:
            h.remove()


def item_size(event: HostEvent, fallback: int) -> int:
    """Bytes per element of an op's first input, from the recorded dtype."""
    names = {"float": 4, "c10::BFloat16": 2, "c10::Half": 2, "double": 8}
    return names.get(event.dtypes[0], fallback) if event.dtypes else fallback


def roofline_share(trace: Trace, ops: Dict[str, callable], fallback_item: int
                   ) -> Optional[float]:
    """Least time over measured device time, in %, over every call of the
    ops in ``ops`` (op name -> least seconds from (shapes, item size))."""
    least = measured = 0.0
    for op, least_fn in ops.items():
        calls = trace.spans(op)
        times = trace.device_s_under(calls)
        for event, sec in zip(calls, times):
            least += least_fn(event.shapes, item_size(event, fallback_item))
            measured += sec
    return 100.0 * least / measured if measured > 0 else None
