"""On the card: each cell's control (the reference one precision lower in
the program's place, at the cell's own size) reads not correct on three
seeds."""
import pytest

from h100_bench import check, inputs, spec
from h100_bench.reference import precision

SEEDS = (2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303)


@pytest.mark.card
@pytest.mark.parametrize("workload", [w["name"] for w in spec.load_benchmark()["workloads"]])
def test_control_is_not_correct(card, workload):
    cell = spec.cell(workload)
    control = precision.BELOW[cell.traffic["dtype"]]
    for seed in SEEDS:
        numbers = check.serve_numbers(cell, seed, card, inputs.Pool(cell.traffic, seed), None,
                                      control)
        print(workload, control, seed, numbers, cell.limits)
        assert not check.verdict(numbers, cell.limits), (control, seed, numbers)
