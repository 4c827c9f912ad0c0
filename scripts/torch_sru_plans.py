#!/usr/bin/env python3
"""Device time of the SRU inference kernels K1 (``sru_stack_layer``) and K4
(``sru_direction``) under every ring depth their C entry points take, at
the main path's shapes, on one CUDA card: the data behind the rule of
``ops/kernels/sru.py:ring_plan``.

    python3 scripts/torch_sru_plans.py [--rounds 2]

For each shape and dtype, each depth D (0 is the narrow kernel; a bfloat16
ring is tried only where its words are aligned) is first held against the
plain version on the same inputs (``torch_kernel_times.tolerance_ok``:
float32 1e-5 + 1e-5*|ref|, bfloat16 one to two ulps), then timed with
``torch_kernel_times.event_ms`` (20 launches, device time only, inputs
rotated past the 50 MB L2) in ``--rounds`` passes over the depths. Prints
one JSON line per shape with the median ms of every depth, the depth
``launch_plan`` picks and the fastest, then the card's name and power
limit. Shapes: K1
(L, rows) = (57, 125 B) and (118, 64 B), k = 3 and 4, for B = 1, 4, 16 in
float32 and bfloat16 and B = 128 in bfloat16; K4 the same (L, rows) for
B = 1, 4, 16, H = 32, one direction, on slices of one (L, rows, 4, 64)
projection.
"""
import argparse
import ctypes
import itertools
import json
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_kernel_times as kt  # noqa: E402  (puts the repo root on the path)

REPS = 20
DEPTHS = (0, 8, 32)


def fail(msg):
    raise RuntimeError(msg)


def shapes(batches):
    return [(B, L, per_utt * B) for B in batches for L, per_utt in ((57, 125), (118, 64))]


def sweep(label, run, want, dtype, plan, rounds):
    """Check and time ``run(depth, i)`` at every depth; one line."""
    for d in DEPTHS:
        ok, err = kt.tolerance_ok(run(d, 0), want, dtype)
        if not ok:
            fail(f"{label} D={d}: max_abs_err {err} out of tolerance")
    it = itertools.count()
    times = {d: [] for d in DEPTHS}
    for _ in range(rounds):
        for d in DEPTHS:
            times[d].append(kt.event_ms(lambda: run(d, next(it)), reps=REPS))
    med = {d: statistics.median(v) for d, v in times.items()}
    best = min(med, key=med.get)
    print("plans " + json.dumps({**label, "plan": plan, "plan_ms": med[plan], "best": best,
                                 "best_ms": med[best], "ms_by_D": med}))


def k1(rounds, gen):
    import torch

    from rtfs_net_tpu_torch.ops.kernels import sru as ksru

    fn = ksru._fn()
    stream = torch.cuda.current_stream().cuda_stream
    O = 2 * kt.H
    for B, L, rows in shapes((1, 4, 16, kt.BIG_BATCH)):
        for k in (4, 3):
            for dtype in ((torch.bfloat16,) if B == kt.BIG_BATCH
                          else (torch.float32, torch.bfloat16)):
                item = torch.tensor([], dtype=dtype).element_size()
                copies = 1 + int(100e6 // ((k * O + (O if k == 3 else 0)) * L * rows * item))
                sets, v, b = kt.sru_inputs(L, rows, k, dtype, gen, copies)
                out = torch.empty((L, O, rows), dtype=dtype, device="cuda")
                u0, s0 = sets[0]
                want = ksru.sru_stack_layer_ref(u0, s0, v, b, H=kt.H, k=k, ndir=2)

                def run(depth, i):
                    if depth and dtype == torch.bfloat16 and rows % 2:
                        depth = 0  # the ring takes no odd bfloat16 rows
                    u, skip = sets[i % copies]
                    err = fn(u.data_ptr(), None if skip is None else skip.data_ptr(),
                             v.data_ptr(), b.data_ptr(), out.data_ptr(), L, rows, kt.H, k, 2,
                             depth, 0 if dtype == torch.float32 else 1, stream)
                    if err:
                        fail(f"sru_stack_layer D={depth}: CUDA error {err}")
                    return out

                sweep({"kernel": "sru_stack_layer", "B": B, "L": L, "rows": rows, "k": k,
                       "dtype": kt.dtype_name(dtype)}, run, want, dtype,
                      ksru.launch_plan(rows, O, item), rounds)
                del sets, out, want


def k4(rounds, gen):
    import torch

    from rtfs_net_tpu_torch.ops.kernels import sru_direction as kdir

    fn = kdir._fn()
    stream = torch.cuda.current_stream().cuda_stream
    O = 2 * kt.H
    for B, L, rows in shapes((1, 4, 16)):
        for dtype in (torch.float32, torch.bfloat16):
            item = torch.tensor([], dtype=dtype).element_size()
            copies = 1 + int(100e6 // (4 * L * rows * kt.H * item))
            us = [torch.randn((L, rows, 4, O), generator=gen, device="cuda").to(dtype)
                  for _ in range(copies)]
            gates = [0.5 * torch.randn(kt.H, generator=gen, device="cuda") for _ in range(4)]
            out = torch.empty((L, rows, kt.H), dtype=dtype, device="cuda")
            ops = [[u[:, :, c, :kt.H] for c in range(4)] for u in us]
            strides = (ctypes.c_int64 * 8)(*(s for t in ops[0] for s in t.stride()[:2]))
            want = kdir.sru_direction_ref(*ops[0], *gates)

            def run(depth, i):
                err = fn(*(t.data_ptr() for t in ops[i % copies]), strides,
                         *(g.data_ptr() for g in gates), out.data_ptr(), L, rows, kt.H, 0,
                         depth, 0 if dtype == torch.float32 else 1, stream)
                if err:
                    fail(f"sru_direction D={depth}: CUDA error {err}")
                return out

            sweep({"kernel": "sru_direction", "B": B, "L": L, "rows": rows,
                   "dtype": kt.dtype_name(dtype)}, run, want, dtype,
                  kdir.launch_plan(rows, kt.H, item), rounds)
            del us, ops, out, want


def main():
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_sru_plans: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(12)
    k1(args.rounds, gen)
    k4(args.rounds, gen)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
