"""The reduction of a profiler trace, on hand-made events."""
import torch

from h100_bench import trace, work

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Event:
    def __init__(self, name, device, start, end, thread=1, corr=0, linked=0, shapes=(),
                 dtypes=(), annotation=False):
        self._v = (name, device, start, end, thread, corr, linked, list(shapes),
                   list(dtypes), annotation)

    def name(self): return self._v[0]
    def device_type(self): return self._v[1]
    def start_ns(self): return self._v[2]
    def end_ns(self): return self._v[3]
    def start_thread_id(self): return self._v[4]
    def correlation_id(self): return self._v[5]
    def linked_correlation_id(self): return self._v[6]
    def shapes(self): return self._v[7]
    def dtypes(self): return self._v[8]
    def is_user_annotation(self): return self._v[9]


def events():
    k1 = [[57, 256, 500], [], [128], [128]]
    return [
        Event(trace.STRETCH, CPU, 0, 100_000, annotation=True),
        Event(trace.STRETCH, CUDA, 0, 100_000),  # the range's device-side copy
        Event("h100_bench.avnet.refinement_module", CPU, 5_000, 60_000, annotation=True),
        Event("rtfs::sru_stack_layer", CPU, 10_000, 20_000, corr=7, shapes=k1,
              dtypes=["c10::BFloat16"]),
        Event("cudaLaunchKernel", CPU, 12_000, 13_000, corr=101, linked=7),
        Event("sru_stack_layer_ring_kernel", CUDA, 14_000, 30_000, corr=101, linked=7),
        Event("aten::add", CPU, 30_000, 40_000, corr=8),
        Event("cudaLaunchKernel", CPU, 31_000, 32_000, corr=102, linked=8),
        Event("vectorized_elementwise_kernel<add>", CUDA, 25_000, 45_000, corr=102, linked=8),
        Event("aten::copy_", CPU, 70_000, 90_000, corr=9),
        Event("cudaMemcpyAsync", CPU, 71_000, 72_000, corr=103, linked=9),
        Event("Memcpy HtoD (Pageable -> Device)", CUDA, 80_000, 85_000, corr=103, linked=9),
    ]


def test_busy_time_launches_and_categories():
    t = trace.Trace(events(), units=2)
    assert t.wall_s == 100e-6
    assert t.busy_intervals() == [(14_000, 45_000), (80_000, 85_000)]
    assert abs(t.busy_s - 36e-6) < 1e-15
    assert t.launch_calls == 3
    assert t.by_category()["sru_kernel"] == 16e-6


def test_device_time_under_ranges_and_ops():
    t = trace.Trace(events(), units=2)
    spans = t.spans("h100_bench.avnet.refinement_module")
    assert t.device_s_under(spans) == [16e-6 + 20e-6]
    share = trace.roofline_share(t, {"rtfs::sru_stack_layer": work.k1_least_s}, 4)
    least = work.k1_least_s([[57, 256, 500], []], 2)
    assert abs(share - 100 * least / 16e-6) < 1e-9


def test_idle_gaps_by_the_host_op_open():
    gaps = dict(trace.Trace(events(), units=2).idle_gaps(least_ns=1))
    # the device idles 0-14 us (nothing open at 0), 45-80 us (the refinement
    # range open at 45) and 85-100 us (aten::copy_ open at 85)
    want = {"host (between operators)": 14e-6, "h100_bench.avnet.refinement_module": 35e-6,
            "aten::copy_": 15e-6}
    assert set(gaps) == set(want)
    assert all(abs(gaps[k] - v) < 1e-12 for k, v in want.items())


def test_a_device_only_trace_takes_the_host_wall():
    light = [e for e in events() if e.device_type() == CUDA or e.name().startswith("cuda")]
    light = [e for e in light if e.name() != trace.STRETCH]
    t = trace.Trace(light, units=2, wall_s=1e-4)
    assert t.wall_s == 1e-4 and t.launch_calls == 3 and abs(t.busy_s - 36e-6) < 1e-15
