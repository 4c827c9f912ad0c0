"""Zoo benchmark (``scripts/bench_zoo.py`` of the JAX side): serving and
training of the four headline configs on one card, beside the paper's
published per-utterance GPU times:

    python -m rtfs_net_tpu_torch.scripts.bench_zoo [--serve-only|--train-only] [--latency]

Each config (``configs/<name>.yaml``) is built from seed 0 and measured
with the port's bench (``rtfs_net_tpu_torch.bench``):

* serving: ``separate`` in bfloat16 at B = 128 from (128, 512, 50) lip
  embeddings, the minimum of 5 calls on distinct inputs (a pool of 4
  mixtures, call i adding i·1e-6) after one warm-up and a float32 sanity
  slice; with ``--latency`` also at B = 1 (the paper's Time(ms) column is
  per-utterance latency);
* training: ``System.train_step`` in bfloat16 with the config's optimizer
  at B = 4 (the reference's per-GPU batch) and 16, the mixture as its
  own target, each from the seed weights, min of 5 steps.

``PAPER_MS`` are the RTFS-Net paper's per-utterance inference times on
its GPU, not measurements of this port. One row per config: ms/utt, utt/s
and the paper's time over ours; the B=1 latency; ms/step and utt/s per
train batch. The last line is JSON with the same figures, each phase's
kernel launches and its peak memory. Runs on a card unless ``--device
cpu``; without one it exits 2 and prints no result.
"""
from __future__ import annotations

import argparse
import json
import sys

from . import device_name, device_or_none, load_config

# (config, the paper's published ms per utterance on its GPU)
ZOO = [("lrs2_RTFSNet_4_layer", 57.8), ("lrs2_RTFSNet_6_layer", 64.7),
       ("lrs2_RTFSNet_12_layer", 109.9), ("lrs2_CTCNet_16_layer", 122.7)]
PAPER_MS = dict(ZOO)
SERVE_BATCH, TRAIN_BATCHES, SAMPLES, ITERS = 128, (4, 16), 32000, 5


def measured(fn, device):
    """``fn()``'s result, its kernel launches and the peak memory (GiB; None
    off a card) it allocated."""
    import torch

    from ..bench import launched

    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    out, launches = launched(fn)
    peak = (torch.cuda.max_memory_allocated(device) / 2 ** 30 if device.type == "cuda"
            else None)
    return out, launches, peak


def bench_config(name, device, conf=None, serve=True, train=True, latency=False,
                 batch=SERVE_BATCH, samples=SAMPLES, train_batches=TRAIN_BATCHES,
                 iters=ITERS):
    """One config's row: serving and B=1 latency (ms per call), train steps
    (ms per step), each phase's launches and peak memory."""
    import numpy as np
    import torch

    from ..bench import request_pool, serving_ms, train_ms
    from ..models import build_model

    conf = conf or load_config(name)
    model = build_model(conf, device=device)
    mixes, mouth = request_pool(batch, samples, conf["audionet"]["pretrained_vout_chan"],
                                np.random.default_rng(0))
    pool = [torch.from_numpy(m).to(device) for m in mixes]
    mouth = torch.from_numpy(mouth).to(device)
    row = {"config": name, "paper_ms_per_utt": PAPER_MS.get(name), "launches": {},
           "peak_mem_GiB": {}, "calls": {}}

    def phase(key, fn, calls):
        ms, row["launches"][key], row["peak_mem_GiB"][key] = measured(fn, device)
        row["calls"][key] = calls
        return ms

    if serve:
        ms = phase("serving", lambda: serving_ms(model, pool, mouth, device, iters), iters + 2)
        row.update(serve_ms=ms, serve_batch=batch, ms_per_utt=ms / batch,
                   utt_per_s=batch / ms * 1e3)
        if latency:
            row["latency_ms"] = phase("latency", lambda: serving_ms(
                model, [m[:1] for m in pool], mouth[:1], device, iters), iters + 2)
    if train:
        for B in train_batches:
            ms = phase(f"train_b{B}", lambda: train_ms(conf, model, pool, mouth, B, device,
                                                       iters), iters + 1)
            row[f"train_b{B}_ms"] = ms
            row[f"train_b{B}_utt_per_s"] = B / ms * 1e3
    return row


def row_text(row):
    """The JAX script's line for ``row``."""
    paper = row["paper_ms_per_utt"]
    parts = [row["config"]]
    if "ms_per_utt" in row:
        parts.append(f"serve {row['ms_per_utt']:.2f} ms/utt ({row['utt_per_s']:.0f} utt/s, "
                     f"paper's GPU {paper} -> {paper / row['ms_per_utt']:.1f}x)")
    if "latency_ms" in row:
        parts.append(f"B=1 latency {row['latency_ms']:.2f} ms "
                     f"(paper's GPU {paper} -> {paper / row['latency_ms']:.1f}x)")
    for key in row:
        if key.startswith("train_b") and key.endswith("_ms"):
            B = key[len("train_b"):-len("_ms")]
            parts.append(f"train B={B} {row[key]:.1f} ms/step "
                         f"({row[f'train_b{B}_utt_per_s']:.0f} utt/s)")
    return "  ".join(parts)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--serve-only", action="store_true")
    p.add_argument("--train-only", action="store_true")
    p.add_argument("--latency", action="store_true",
                   help="also measure unamortized B=1 serving latency (the paper's "
                        "Time(ms) column is per-utterance latency)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = device_or_none("bench_zoo", args.device)
    if device is None:
        return 2
    rows = []
    for name, _ in ZOO:
        rows.append(bench_config(name, device, serve=not args.train_only,
                                 train=not args.serve_only, latency=args.latency))
        print(row_text(rows[-1]), flush=True)
    print(json.dumps({"tool": "bench_zoo", "device": device_name(device), "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
