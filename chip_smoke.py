#!/usr/bin/env python3
"""The PyTorch port's checks on one NVIDIA card, in one command:

    python3 chip_smoke.py    # needs one CUDA card and nvcc

1. Every card-marked test (``tests/test_torch_card_*.py``: each kernel
   against its plain version, the launches of every configuration's
   serving forward and train step, every entry point on its card path),
   through pytest without the suite's ``conftest.py``; it stops here if
   one fails. To run or select them alone::

       python3 -m pytest --noconftest -p no:cacheprovider -m card tests/test_torch_card_*.py

2. A ``{"kernels": [...]}`` line, a row per op of ``ops.kernels.KERNELS``:
   its source, the TPU kernel it replaces, its launches on each path that
   launches it (``torch_kernel_times.path_launches``: each path counted
   from just before one call of it to just after), and its device ms,
   plain ms and bound at PERF.md §6's shapes
   (``scripts/torch_kernel_times.py``, which fails if a summed row counted
   other launches than its path made).
3. ``{"ok": true, "device": {...}}`` last.

Everything on the card runs with TF32 off.
"""
import glob
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "scripts"))


def kernels_line(rows, paths):
    """The ``kernels`` line's rows: per op of the table, its launches by
    path and the tool's rows of it, each keeping its shape and times."""
    from rtfs_net_tpu_torch.ops.kernels import KERNELS

    return [{"name": k.op, "source": f"rtfs_net_tpu_torch/csrc/{k.module.SOURCE}",
             "replaces": k.replaces,
             "launches_by_path": {path: counts[k.label] for path, counts in paths.items()
                                  if counts[k.label]},
             "timed": [{key: value for key, value in r.items() if key != "kernel"}
                       for r in rows if r["kernel"] == k.op]}
            for k in KERNELS]


def main():
    import pytest
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    os.chdir(HERE)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    rc = pytest.main(["--noconftest", "-p", "no:cacheprovider", "-m", "card", "-q", "-rfE",
                      *sorted(glob.glob("tests/test_torch_card_*.py"))])
    if rc != 0:
        print(f"chip_smoke: FAILED: the card tests exited {int(rc)}", file=sys.stderr)
        return 1
    import torch_kernel_times as kt

    torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    rows = kt.kernel_rows(torch.Generator(device="cuda").manual_seed(0))
    paths = kt.path_launches()
    kt.check_launches(rows, paths)
    print(kt.card_name())
    print(json.dumps({"kernels": kernels_line(rows, paths)}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
