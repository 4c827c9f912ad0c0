"""What a cell is, found by name: its entry in ``BENCHMARK.json``, the
configuration file the entry names, the configuration's plain reference
(named by ``reference/<config>.json``), the traffic file
``traffic/<traffic>.json``, the metrics that the cell reports (each read by
``metrics/<name>.py``, or by ``metrics/<stem>.py`` for a name
``<stem>.<suffix>``) and its correctness limits ``limits/<workload>.json``."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Dict, List

import yaml

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    conf: Dict
    traffic_name: str
    traffic: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]
    limits: Dict
    reference: str  # the plain reference module's path, from the repository's root


def load_benchmark() -> Dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def reference_files(config: str) -> Dict[str, str]:
    """``reference/<config>.json``: the paths, from the repository's root,
    of the configuration's plain reference module (``reference``), of the
    port's YAML that its file copies (``published``) and of the model at
    tiny widths for the CPU tests (``tiny``)."""
    with open(HERE / "reference" / f"{config}.json") as f:
        return json.load(f)


def reference(path: str):
    """The plain reference module at ``path``, imported by its dotted name,
    so that its classes exist once however many callers resolve it."""
    return importlib.import_module(path.removesuffix(".py").replace("/", "."))


def _reports(metric: Dict, cell: str) -> bool:
    return cell in metric["workloads"] if "workloads" in metric else True


def cell(name: str, bench: Dict = None) -> Cell:
    bench = bench or load_benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    config = next(c for c in bench["configs"] if c["name"] == entry["config"])
    with open(ROOT / config["file"]) as f:
        conf = yaml.safe_load(f)
    with open(HERE / "traffic" / f"{entry['traffic']}.json") as f:
        traffic = json.load(f)
    with open(HERE / "limits" / f"{name}.json") as f:
        limits = json.load(f)
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if m["moves"] in moved and _reports(m, name)]
    return Cell(name, entry["config"], conf, entry["traffic"], traffic, e2e, per_layer, limits,
                reference_files(entry["config"])["reference"])


def reader(metric: str):
    """The module that reads ``metric``."""
    for stem in (metric, metric.split(".", 1)[0]):
        path = HERE / "metrics" / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(f"h100_bench.metrics.{stem}", path)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            return module
    raise FileNotFoundError(f"no reader for metric {metric!r} under metrics/")
