#!/usr/bin/env python3
"""Serving forward times of the port beside another tree's, on one CUDA card:
RTFS-Net-4 at full width (random weights from seed 0) from (B, 512, 50) lip
embeddings, float32 with TF32 off, through ``separate()``, as
``chip_smoke.py``'s ``serving`` phase times it.

    python3 scripts/torch_serving_ab.py --parent DIR [--batches 1,16] [--reps 7] [--rounds 1]

DIR is a checkout of the port (e.g. ``git archive <commit>`` unpacked). Each
turn is a fresh process that imports one tree's package, builds its kernels
into that tree and times ``--reps`` synchronised forwards per batch on the
host clock after one warm-up, with the kernels' launch counts of one
forward; then the host's time per call of the K1 and K3 wrappers at a tiny
shape (the enqueue of ``CALLS`` calls, which the card runs faster than the
host issues them). Each round runs the turns parent, change, change,
parent, so both trees meet the card warm and cold alike. Prints one JSON
line per turn, then per kernel and per batch each tree's median over its
turns, and the card's name and power limit.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CALLS = 2000  # wrapper calls timed per kernel for the host cost of one call


def child(tree, batches, reps):
    """One turn, in a process whose ``rtfs_net_tpu_torch`` is ``tree``'s."""
    sys.path.insert(0, tree)
    import torch
    import yaml

    from rtfs_net_tpu_torch.models import build_model
    from rtfs_net_tpu_torch.ops.kernels import dw_conv, sru
    from rtfs_net_tpu_torch.utils.separator import separate

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with open(os.path.join(tree, "rtfs_net_tpu_torch", "configs",
                           "lrs2_RTFSNet_4_layer.yaml")) as f:
        conf = yaml.safe_load(f)
    model = build_model(conf, device="cuda", generator=torch.Generator().manual_seed(0))
    gen = torch.Generator(device="cuda").manual_seed(1)
    out = {"tree": tree, "ms_median": {}, "ms_min": {}, "launches": {}}
    for B in batches:
        mix = torch.randn((B, 32000), generator=gen, device="cuda")
        emb = 0.1 * torch.randn((B, 512, 50), generator=gen, device="cuda")
        sru.launches = dw_conv.launches = 0
        separate(model, mix, emb)  # warm-up, counted
        torch.cuda.synchronize()
        out["launches"][B] = {"K1": sru.launches, "K3": dw_conv.launches}
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            separate(model, mix, emb)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        times.sort()
        out["ms_median"][B] = times[len(times) // 2]
        out["ms_min"][B] = times[0]
    # host time per wrapper call at a tiny shape, whose kernel takes the card
    # less time than the host takes to launch it
    u = torch.randn((2, 3 * 64, 128), generator=gen, device="cuda")
    skip = torch.randn((2, 64, 128), generator=gen, device="cuda")
    v, b = (torch.randn(128, generator=gen, device="cuda") for _ in range(2))
    x = torch.randn((1, 4, 8, 8), generator=gen, device="cuda")
    w = torch.randn((4, 1, 4, 4), generator=gen, device="cuda")
    calls = {"K1": lambda: sru.sru_stack_layer(u, skip, v, b, H=32, k=3, ndir=2),
             "K3": lambda: dw_conv.dw_conv2d_same(x, w, ((1, 2), (1, 2)))}
    out["host_us_per_call"] = {}
    with torch.no_grad():
        for name, call in calls.items():
            for _ in range(100):
                call()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(CALLS):
                call()
            out["host_us_per_call"][name] = (time.perf_counter() - t0) / CALLS * 1e6
            torch.cuda.synchronize()
    print(json.dumps(out))


def main():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--parent", help="the other tree")
    p.add_argument("--batches", default="1,16")
    p.add_argument("--reps", type=int, default=7)
    p.add_argument("--rounds", type=int, default=1)
    p.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = p.parse_args()
    batches = [int(b) for b in args.batches.split(",")]
    if args.child:
        return child(args.child, batches, args.reps)
    trees = {"parent": os.path.abspath(args.parent), "change": ROOT}
    medians = {name: {B: [] for B in batches} for name in trees}
    host_us = {name: [] for name in trees}
    for name in ("parent", "change", "change", "parent") * args.rounds:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", trees[name],
                               "--batches", args.batches, "--reps", str(args.reps)],
                              capture_output=True, text=True, cwd=trees[name])
        if proc.returncode:
            sys.stderr.write(proc.stderr)
            raise SystemExit(f"the {name} turn failed")
        line = json.loads(proc.stdout.strip().splitlines()[-1])
        print("turn " + json.dumps({"which": name, **line}))
        for B in batches:
            medians[name][B].append(line["ms_median"][str(B)])
        host_us[name].append(line["host_us_per_call"])
    for kernel in ("K1", "K3"):
        print("ab " + json.dumps({
            "host_us_per_call": kernel,
            **{f"{name}_median": statistics.median(t[kernel] for t in host_us[name])
               for name in trees},
            **{f"{name}_turns": [t[kernel] for t in host_us[name]] for name in trees}}))
    for B in batches:
        print("ab " + json.dumps({
            "dtype": "float32", "B": B, "from": "embeddings",
            **{f"{name}_ms_median": statistics.median(medians[name][B]) for name in trees},
            **{f"{name}_turn_medians": medians[name][B] for name in trees}}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())


if __name__ == "__main__":
    main()
