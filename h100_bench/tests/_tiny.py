"""A benchmark cell at tiny widths and sizes, for runs on the CPU."""
import dataclasses
import json

import yaml

from h100_bench import spec

SMALL = dict(seconds_of_audio=0.25, frames=6, frame_size=24, check_block=2, pool=2,
             frame_pool=2, trace_units=1, warmup=1)


# Cells whose files the benchmark keeps but BENCHMARK.json does not hold:
# their configuration, traffic and end-to-end metrics (their limits are
# ``limits/<workload>.json``)
KEPT = {"rtfs4-serve-b1": ("rtfsnet4-lrs2", "serve_request", "serve_p95_ms")}


def kept_cell(workload: str) -> spec.Cell:
    config, traffic, metric = KEPT[workload]
    bench = spec.load_benchmark()
    file = next(c["file"] for c in bench["configs"] if c["name"] == config)
    conf = yaml.safe_load((spec.ROOT / file).read_text())
    t = json.loads((spec.HERE / "traffic" / f"{traffic}.json").read_text())
    limits = json.loads((spec.HERE / "limits" / f"{workload}.json").read_text())
    e2e = [{"name": "setup_s", "unit": "s"}, {"name": metric, "unit": "ms"}]
    return spec.Cell(workload, config, conf, traffic, t, e2e, [], limits,
                     spec.reference_files(config)["reference"])


def tiny_conf(config: str) -> dict:
    """``config``'s model at tiny widths, the YAML its reference file names."""
    return yaml.safe_load((spec.ROOT / spec.reference_files(config)["tiny"]).read_text())


def tiny_cell(workload: str, **traffic) -> spec.Cell:
    """``workload``'s cell, its limits and metrics as they are, with its
    model at tiny widths and small inputs; ``traffic`` overrides more."""
    cell = kept_cell(workload) if workload in KEPT else spec.cell(workload)
    conf = tiny_conf(cell.config_name)
    t = {**cell.traffic, **SMALL, "batch": min(cell.traffic["batch"], 4),
         "check_calls": min(cell.traffic["check_calls"] if "check_calls" in cell.traffic
                            else 1, 2), **traffic}
    return dataclasses.replace(cell, conf=conf, traffic=t)


# The training path, which no cell of BENCHMARK.json holds: a float32 program
# against the float32 reference agrees to round-off in each number.
TRAIN_LIMITS = {"loss_gap_first_db": 1e-3, "grad_gap_median": 1e-3, "change_gap_median": 1e-3}


def tiny_train_cell(**traffic) -> spec.Cell:
    """RTFS-Net-4 at tiny widths under ``traffic/train_step.json`` with
    small inputs in float32, its window read as ``train_utt_per_s``."""
    conf = tiny_conf("rtfsnet4-lrs2")
    t = json.loads((spec.HERE / "traffic" / "train_step.json").read_text())
    t = {**t, **SMALL, "batch": min(t["batch"], 4), "dtype": "float32", **traffic}
    t["frame_pool"] = t["pool"]
    e2e = [{"name": "setup_s", "unit": "s"}, {"name": "train_utt_per_s", "unit": "utt/s"}]
    return spec.Cell("train", "rtfsnet4-lrs2", conf, "train_step", t, e2e, [],
                     dict(TRAIN_LIMITS), spec.reference_files("rtfsnet4-lrs2")["reference"])
