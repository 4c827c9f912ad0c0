"""A run with the timed path broken underneath reads ``correct`` false:
the harness's look for a card skipped, the rest of a run driven on the CPU
at tiny widths, with each cell's own limits."""
import time

import pytest
import torch

from h100_bench import drive, inputs, program, run, spec

from _tiny import KEPT, tiny_cell, tiny_train_cell

SEED = 2 ** 31 + 7
# every serving cell: BENCHMARK.json's and the ones whose files are kept
SERVE = [w["name"] for w in spec.load_benchmark()["workloads"]] + list(KEPT)


def test_sound_runs_are_correct():
    for workload in SERVE + ["train"]:
        cell = (tiny_train_cell() if workload == "train"
                else tiny_cell(workload, dtype="float32"))
        out = run.run_cell(cell, SEED, 0.1, False, "cpu", time.time())
        assert out["correct"], (workload, out["numbers"])


@pytest.mark.parametrize("workload", SERVE)
def test_an_answer_altered_where_it_is_produced(workload, monkeypatch):
    separate = program.separate

    def altered(*args, **kwargs):
        out = separate(*args, **kwargs)
        out[0] = -out[0]
        return out

    monkeypatch.setattr(program, "separate", altered)
    out = run.run_cell(tiny_cell(workload, dtype="float32"), SEED, 0.1, False, "cpu",
                       time.time())
    assert out["numbers"]["max_rel_err"] > 1.0 and not out["correct"]


def test_a_step_that_returns_its_state_unchanged(monkeypatch):
    call = drive.Train.call

    def unchanged(self, i):
        before = [p.detach().clone() for p in self.system.model.parameters()]
        out = call(self, i)
        with torch.no_grad():
            for p, b in zip(self.system.model.parameters(), before):
                p.copy_(b)
        return out

    monkeypatch.setattr(drive.Train, "call", unchanged)
    out = run.run_cell(tiny_train_cell(), SEED, 0.1, False,
                       "cpu", time.time())
    assert out["numbers"]["change_gap"] == pytest.approx(1.0) and not out["correct"]


def test_half_of_the_batch_left_out(monkeypatch):
    def half(self, i):
        mix, target, frames = (t[:len(t) // 2].to(self.device, copy=True)
                               for t in self.host[i % len(self.host)])
        mix[:, 0] += inputs.Pool.stamp(i).item()
        return self.system.train_step((mix, target, frames), self.generator)

    monkeypatch.setattr(drive.Train, "call", half)
    out = run.run_cell(tiny_train_cell(), SEED, 0.1, False,
                       "cpu", time.time())
    assert not out["correct"], out["numbers"]
