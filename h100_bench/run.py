"""One run of one cell:

    python -m h100_bench --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up makes the weights on the card from the seed, builds the port's
models, makes the request pool, and warms up the cell's own shapes (for a
training cell: its first steps, which the check reads). The window then
runs for ``--seconds``; with ``--trace 1`` a profiled stretch follows it.
Then the program's state is freed and the reference checks the window's
results. Earlier lines report the device, the window, the kernels'
launches and the memory; the numbers compared go last to standard error;
the last line of standard output is the result.
"""
from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional

import torch

from . import check, drive, inputs, program, spec, work

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "rtfs_net_tpu")


class Run:
    """What a metric's reader reads."""

    def __init__(self, cell, setup_s: float, window: drive.Window, driver):
        self.cell, self.traffic = cell, cell.traffic
        self.setup_s, self.window, self.driver = setup_s, window, driver
        self.trace = None  # the traced stretch with host operators
        self.light = None  # the device-only traced stretch

    @property
    def flops_per_utterance(self) -> float:
        return work.reference_flops(self.cell.reference,
                                    json.dumps(self.cell.conf, sort_keys=True),
                                    json.dumps(self.traffic, sort_keys=True))


def forbidden_modules() -> List[str]:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def device_lines() -> Dict:
    info = {"kind": torch.cuda.get_device_name(0), "torch": torch.__version__,
            "cuda": torch.version.cuda}
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        info["nvidia_smi"] = smi.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        info["nvidia_smi"] = "not read"
    return info


def run_cell(cell, seed: int, seconds: float, traced: bool, device, started: float) -> Dict:
    """Set-up, window, optional traced stretch, check; returns the result
    and the earlier lines' numbers."""
    ref_model, ref_video = check.reference_models(cell.reference, cell.conf, seed, device)
    model, video = program.build(cell.conf, device, ref_model.state_dict(),
                                 ref_video.state_dict())
    del ref_model, ref_video
    pool = inputs.Pool(cell.traffic, seed)
    driver = drive.make(cell, seed, device, model, video, pool)
    readings = None
    if cell.traffic["kind"] == "train":
        readings = check.program_train_readings(driver, cell.traffic["check_steps"])
        first = cell.traffic["check_steps"]
    else:
        warm = cell.traffic["warmup"]
        driver.run(-warm, drive.Window(), lambda n: n >= warm, False)
        first = 0
    drive.synchronize(device)
    setup_s = time.time() - started

    w = drive.window(driver, seconds, first)
    run = Run(cell, setup_s, w, driver)
    metrics_of = cell.per_layer if traced else cell.end_to_end
    readers = {m["name"]: spec.reader(m["name"]) for m in metrics_of}
    if traced:
        def install() -> Callable:
            undos = [r.install(run) for r in readers.values() if hasattr(r, "install")]
            return lambda: [u() for u in undos]

        drive.stretch(driver, cell.traffic["trace_units"], first + w.units, install, w)
        run.trace, run.light = w.stretch, w.light
    cuda = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    metrics = {}
    for m in metrics_of:
        value = readers[m["name"]].read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    outputs = w.outputs
    del driver, model, video, run
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    if cell.traffic["kind"] == "train":
        numbers = check.train_numbers(cell, seed, device, pool, readings)
    else:
        numbers = check.serve_numbers(cell, seed, device, pool, outputs)
    return {"setup_s": setup_s, "window": w, "peak": peak, "metrics": metrics,
            "numbers": numbers, "correct": check.verdict(numbers, cell.limits),
            "check_s": time.perf_counter() - t0}


def parse(argv=None):
    p = argparse.ArgumentParser(prog="python -m h100_bench", description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, started: Optional[float] = None) -> int:
    started = time.time() if started is None else started
    args = parse(argv)
    bench = spec.load_benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        print(f"h100_bench: no workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"h100_bench: {args.workload} needs {entry['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    cell = spec.cell(args.workload, bench)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", started)
    w = out["window"]
    print("device " + json.dumps(device_lines()))
    window = {"units": w.units, "utterances": w.utterances, "seconds": w.seconds,
              "setup_s": out["setup_s"], "check_s": out["check_s"], "peak_bytes": out["peak"],
              "launches_per_unit": {k: n / max(w.units, 1) for k, n in w.launches.items()}}
    if w.latencies:
        lat = sorted(w.latencies)
        n = len(w.latencies)
        # the median of each third of the window, in order: drift inside a run
        thirds = [sorted(w.latencies[k * n // 3:(k + 1) * n // 3]) for k in range(3)]
        window["latency_ms"] = {"p50": 1e3 * lat[n // 2], "max": 1e3 * lat[-1],
                                "p50_by_third": [1e3 * t[len(t) // 2] for t in thirds if t]}
    print("window " + json.dumps(window))
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
              "memory_peak_bytes": out["peak"]}
    result = {"correct": out["correct"], "attempted": w.utterances if cell.traffic[
        "kind"] == "serve" else w.units, "failed": 0, "metrics": out["metrics"],
        "device": device}
    if w.stretch is not None:
        light, full = w.light, w.stretch
        device.update({"busy_s": light.busy_s, "window_s": light.wall_s})
        untraced = w.utterances / w.seconds
        rates = {"untraced": untraced, "device_only": w.stretch_utterances / light.wall_s,
                 "with_host_ops": w.stretch_utterances / full.wall_s}
        print("stretch " + json.dumps({
            "units": light.units, "utt_per_s": rates,
            "tracing_overhead": {k: untraced / v - 1.0 for k, v in rates.items()
                                 if k != "untraced"},
            "launch_calls_per_unit": light.launch_calls / max(light.units, 1),
            "by_category_s": dict(light.by_category().most_common())}))
        cats = [[f"category {c}", s] for c, s in light.by_category().most_common(5)]
        kernels = [[n[:120], s] for n, s in light.by_kernel().most_common(10 - len(cats))]
        result["breakdown"] = {"device_ops": cats + kernels,
                               "idle_gaps": [[n, s] for n, s in full.idle_gaps()]}
    limits = cell.limits
    numbers = out["numbers"]
    print("check " + json.dumps(numbers))
    checks = {k: {"value": numbers.get(k), "limit": v} for k, v in limits.items()}
    result["checks"] = checks
    bad = forbidden_modules()
    if bad:
        print(f"h100_bench: the process holds {bad}; the benchmark runs the port alone",
              file=sys.stderr)
        return 3
    for k, v in checks.items():
        print(f"check {k} = {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0
