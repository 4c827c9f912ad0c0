"""Serving batch sweep (``scripts/bench_sweep.py`` of the JAX side): the
throughput-optimal serving batch of RTFS-Net-4 on one card:

    python -m rtfs_net_tpu_torch.scripts.bench_sweep [--batches 96 128 160 192 256]

For each batch B: RTFS-Net-4 (``configs/lrs2_RTFSNet_4_layer.yaml``, seed
0) serves 2 s mixtures with (B, 512, 50) lip embeddings through
``separate`` in bfloat16, timed by the port's bench
(``rtfs_net_tpu_torch.bench.serving_ms``: a float32 sanity slice, one
warm-up, then the minimum of 5 calls on a pool of 3 mixtures, call i
adding i·1e-6). The mixtures and embeddings are drawn from one
``numpy.random.default_rng(0)`` stream across the batches, as in the JAX
script. It prints ms per utterance and utterances per second per batch,
then the best, then a line of JSON with each batch's launches and peak
memory. Runs on a card unless ``--device cpu``; without one it exits 2.

The JAX script's ``--unrolls`` sweeps the scan's ``eval_unroll``, a TPU
lowering the port leaves out (its SRU recurrence is a hand-written
kernel, not an unrolled scan): the flag is refused.
"""
from __future__ import annotations

import argparse
import json
import sys

from . import device_name, device_or_none, load_config

CONFIG = "lrs2_RTFSNet_4_layer"
BATCHES = [96, 128, 160, 192, 256]
SAMPLES, POOL, ITERS = 32000, 3, 5


def sweep(device, batches=BATCHES, conf=None, samples=SAMPLES, iters=ITERS, log=print):
    """Each batch's serving time: rows of B, ms per call and per
    utterance, utt/s, launches and peak memory; and the best row."""
    import numpy as np
    import torch

    from ..bench import request_pool, serving_ms
    from ..models import build_model
    from .bench_zoo import measured

    conf = conf or load_config(CONFIG)
    model = build_model(conf, device=device)
    rng = np.random.default_rng(0)
    rows = []
    for B in batches:
        mixes, mouth = request_pool(B, samples, conf["audionet"]["pretrained_vout_chan"],
                                    rng, pool=POOL)
        pool = [torch.from_numpy(m).to(device) for m in mixes]
        mouth = torch.from_numpy(mouth).to(device)
        ms, launches, peak = measured(lambda: serving_ms(model, pool, mouth, device, iters),
                                      device)
        del pool, mouth
        rows.append({"B": B, "ms": ms, "ms_per_utt": ms / B, "utt_per_s": B / ms * 1e3,
                     "launches": launches, "calls": iters + 2, "peak_mem_GiB": peak})
        if log is not None:
            log(f"B={B:4d}: {ms / B:.3f} ms/utt ({rows[-1]['utt_per_s']:.1f} utt/s)",
                flush=True)
    return rows, max(rows, key=lambda r: r["utt_per_s"])


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--batches", type=int, nargs="+", default=BATCHES)
    p.add_argument("--unrolls", nargs="*", help=argparse.SUPPRESS)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if args.unrolls is not None:
        p.error("--unrolls sweeps JAX's scan eval_unroll, a TPU lowering the port leaves "
                "out; the port has nothing to unroll")
    device = device_or_none("bench_sweep", args.device)
    if device is None:
        return 2
    rows, best = sweep(device, args.batches)
    print(f"best: {best['utt_per_s']:.1f} utt/s at B={best['B']}")
    print(json.dumps({"tool": "bench_sweep", "device": device_name(device), "rows": rows,
                      "best_batch": best["B"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
