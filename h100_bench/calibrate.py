"""Readings that a cell's correctness limits are set from, in one process:

    python -m h100_bench.calibrate --workload <name> --seeds 1,2,3 \\
        [--controls 4,5,6] [--faults 7,8,9] [--seconds 3]

For each of ``--seeds`` a run of the program (a short window, then the
check), for each of ``--controls`` the cell's control (the reference one
precision below the traffic's ``dtype`` in the program's place),
and for a training cell each of ``--faults`` the reference with half of
the batch left out. One JSON line each, then their largest and smallest.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time

import torch


def main(argv=None) -> int:
    from . import check, inputs, run, spec
    from .reference import precision

    p = argparse.ArgumentParser(prog="python -m h100_bench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--controls", default="")
    p.add_argument("--faults", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    seeds = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    numbers = {"program": [], "control": [], "fault": []}
    train = cell.traffic["kind"] == "train"
    for seed in seeds(args.seeds):
        out = run.run_cell(cell, seed, args.seconds, False, "cuda", time.time())
        numbers["program"].append(out["numbers"])
        print(json.dumps({"program": seed, "numbers": out["numbers"],
                          "correct": out["correct"], "metrics": out["metrics"]}), flush=True)
    for kind, control in (("control", precision.BELOW[cell.traffic["dtype"]]),
                          ("fault", check.HALF_BATCH)):
        for seed in seeds(getattr(args, kind + "s")) if kind == "control" or train else ():
            pool = inputs.Pool(cell.traffic, seed)
            try:
                got = (check.train_numbers(cell, seed, "cuda", pool, None, control) if train
                       else check.serve_numbers(cell, seed, "cuda", pool, None, control))
            except Exception as exc:  # a control that crashes has failed
                got = {"error": repr(exc)}
            numbers[kind].append(got)
            print(json.dumps({kind: seed, "as": control, "numbers": got,
                              "correct": check.verdict(got, cell.limits)}), flush=True)
            torch.cuda.empty_cache()
    summary = {}
    for kind, rows in numbers.items():
        for name in sorted({k for r in rows for k in r if k != "error"}):
            vals = [r[name] for r in rows if isinstance(r.get(name), (int, float))]
            if vals:
                summary[f"{kind}.{name}"] = {"max": max(vals), "min": min(vals),
                                             "n": len(vals),
                                             "finite": all(map(math.isfinite, vals))}
    print("summary " + json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
