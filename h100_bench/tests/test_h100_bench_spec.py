"""BENCHMARK.json against the benchmark's contract, and every cell's
files found by name."""
import json
import re
from pathlib import Path

import pytest
import yaml

from h100_bench import spec

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTHS = re.compile(r"(hidden|intermediate|latent|state|projection|head|expansion|_dim$|_rank$)")


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert 1 <= len(BENCH["paths"]) <= 16 and len(BENCH["command"]) <= 32
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and not p.startswith("/")
        assert (spec.ROOT / p).is_dir() and not p.endswith("_torch")
    for word in BENCH["command"]:
        assert 1 <= len(word) <= 200 and not word.startswith("/") and ".." not in word
    assert len(json.dumps(BENCH).encode()) <= 64 * 1024


def test_names_units_and_entry_keys():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) and not WIDTHS.search(k) for k in c["reduced"])
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        names.append(w["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for entry in BENCH["configs"] + BENCH["workloads"] + BENCH["per_layer"]:
        for key in ("why", "layer", "source"):
            if key in entry:
                assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key]
                assert "\t" not in entry[key]
    assert len(names) == len(set(names))
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves_to_its_files(workload):
    cell = spec.cell(workload)
    assert cell.traffic["kind"] in ("serve", "train")
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        module = spec.reader(m["name"])
        assert callable(module.read)
    for m in cell.per_layer:
        assert m["moves"] in e2e
    assert cell.limits and all(v > 0 for v in cell.limits.values())


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_is_the_published_config(config):
    """The file as run is the port's shipped YAML of that model, the one
    its reference file names, with nothing reduced."""
    path = spec.ROOT / config["file"]
    assert path.resolve().is_relative_to((spec.ROOT / BENCH["paths"][0]).resolve())
    shipped = spec.ROOT / spec.reference_files(config["name"])["published"]
    assert shipped.resolve().parent == (spec.ROOT / "rtfs_net_tpu_torch" / "configs").resolve()
    ours = yaml.safe_load(path.read_text())
    theirs = yaml.safe_load(shipped.read_text())
    assert ours == theirs and config["reduced"] == []


def test_files_under_paths_are_named_from_name_characters():
    for p in Path(spec.HERE).rglob("*"):
        if "__pycache__" in p.parts or "cache" in p.relative_to(spec.HERE).parts[:1]:
            continue
        assert re.fullmatch(r"[A-Za-z0-9_./-]+", str(p.relative_to(spec.ROOT))), p


def test_per_layer_workloads_report_what_they_move():
    for m in BENCH["per_layer"]:
        moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        for w in m["workloads"]:
            assert "workloads" not in moved or w in moved["workloads"]
