"""A configuration added as new files only, in a copy of the benchmark's
files: its entry in ``BENCHMARK.json``, its configuration file, its
reference file naming a reference module outside ``reference/``
(``added_reference.py``: ``model.py``'s models and a weight rule of its
own), its cell and its limits. The harness finds all of it by name and
reads, on the CPU, what it reads for the configuration it copies."""
import json
import shutil
import time

import pytest
import torch
from torch import nn

from h100_bench import check, inputs, run, spec, weights, work

from _tiny import tiny_cell

CONFIG, CELL = "added-lrs2", "added-serve-b128"
COPIED_CONFIG, COPIED_CELL = "rtfsnet4-lrs2", "rtfs4-serve-b128"
MODULE = "h100_bench/tests/added_reference.py"
SEED = 2 ** 31 + 19


@pytest.fixture
def added(tmp_path, monkeypatch):
    """The benchmark's files copied to ``tmp_path``, with a configuration
    and a cell that copy ``rtfsnet4-lrs2`` and ``rtfs4-serve-b128`` added
    beside them; ``spec`` reads the copy."""
    here = tmp_path / "h100_bench"
    shutil.copytree(spec.HERE, here, ignore=shutil.ignore_patterns("__pycache__", "cache"))
    bench = spec.load_benchmark()
    config = next(c for c in bench["configs"] if c["name"] == COPIED_CONFIG)
    bench["configs"].append({**config, "name": CONFIG,
                             "file": f"h100_bench/configs/{CONFIG}.yaml"})
    cell = next(w for w in bench["workloads"] if w["name"] == COPIED_CELL)
    bench["workloads"].append({**cell, "name": CELL, "config": CONFIG})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if COPIED_CELL in m.get("workloads", ()):
            m["workloads"].append(CELL)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    shutil.copy(here / "configs" / f"{COPIED_CONFIG}.yaml", here / "configs" / f"{CONFIG}.yaml")
    shutil.copy(here / "limits" / f"{COPIED_CELL}.json", here / "limits" / f"{CELL}.json")
    files = {**json.loads((here / "reference" / f"{COPIED_CONFIG}.json").read_text()),
             "reference": MODULE}
    (here / "reference" / f"{CONFIG}.json").write_text(json.dumps(files))
    monkeypatch.setattr(spec, "ROOT", tmp_path)
    monkeypatch.setattr(spec, "HERE", here)


def test_the_added_cell_resolves_to_its_files(added):
    cell, copied = spec.cell(CELL), spec.cell(COPIED_CELL)
    assert (cell.config_name, cell.reference) == (CONFIG, MODULE)
    assert spec.reference(cell.reference).__name__ == "h100_bench.tests.added_reference"
    assert (cell.conf, cell.traffic, cell.limits) == (copied.conf, copied.traffic, copied.limits)
    assert cell.end_to_end == copied.end_to_end and cell.per_layer == copied.per_layer


def test_the_added_reference_draws_the_same_weights_and_flops(added):
    cell, copied = spec.cell(CELL), spec.cell(COPIED_CELL)
    for ours, theirs in zip(check.reference_models(cell.reference, cell.conf, SEED, "cpu"),
                            check.reference_models(copied.reference, copied.conf, SEED, "cpu")):
        a, b = ours.state_dict(), theirs.state_dict()
        assert list(a) == list(b) and all(torch.equal(a[k], b[k]) for k in a)
    flops = [work.reference_flops(c.reference, json.dumps(c.conf, sort_keys=True),
                                  json.dumps(c.traffic, sort_keys=True)) for c in (cell, copied)]
    assert flops[0] == flops[1] > 0


def test_the_added_cell_runs_and_checks_as_the_one_it_copies(added):
    """Set up, window and check at tiny widths; the control's numbers, which
    depend on no timing, equal the copied cell's."""
    cell, copied = (tiny_cell(w, dtype="float32") for w in (CELL, COPIED_CELL))
    assert cell.conf == copied.conf and cell.reference == MODULE
    out = run.run_cell(cell, SEED, 0.1, False, "cpu", time.time())
    assert out["correct"], out["numbers"]
    numbers = [check.serve_numbers(c, SEED, "cpu", inputs.Pool(c.traffic, SEED), None,
                                   "bfloat16") for c in (cell, copied)]
    assert numbers[0] == numbers[1] and numbers[0]["max_rel_err"] > 0


def test_a_reference_brings_its_own_weight_rule():
    """``Scale.weight`` is drawn about the centre its module declares, 1;
    on ``model.py``'s rules alone it is a lone vector, drawn about 0."""
    module = spec.reference(MODULE)
    scale = module.Scale(4096)
    (state, _), (plain, _) = (weights.make_state(scale, nn.Identity(), SEED, "cpu", init)
                              for init in (module.INIT, spec.reference(
                                  "h100_bench/reference/model.py").INIT))
    w = state["weight"]
    assert 0.9 <= w.min() and w.max() <= 1.1 and abs(float(w.mean()) - 1.0) < 0.01
    assert plain["weight"].abs().max() <= 0.1 and abs(float(plain["weight"].mean())) < 0.01
