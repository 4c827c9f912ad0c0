"""The port's benchmark on one card (the JAX package's ``bench.py``):

    python -m rtfs_net_tpu_torch.bench

Prints, as its last line, one JSON object with ``bench.py``'s keys
(``bench.py:121-131``):

* serving: RTFS-Net-4 (``configs/lrs2_RTFSNet_4_layer.yaml``, weights from
  seed 0) separating 2 s mixtures given precomputed (128, 512, 50) lip
  embeddings in bfloat16, through ``utils.separator.separate``: a pool of
  4 mixtures, call i adding i·1e-6 so that no two calls share inputs, the
  embeddings scaled by 0.1 (``bench.py:47-54,71-78``), after a check that
  a float32 slice of 8 gives finite output; ``value`` is utterances per
  second, ``vs_baseline`` the reference's published 57.8 ms per utterance
  over ours;
* training: ``System.train_step`` with the config's AdamW in bfloat16 at
  B = 4 and B = 16, the mixture as its own target (``bench.py:83-118``),
  each batch size from the seed weights with the training state carried
  from step to step.

Each is timed by ``utils.profiling.timed``: one warm-up call, then the
minimum of 6 calls on distinct inputs, each fenced by a
``torch.cuda.synchronize()`` and timed by CUDA events. The line before the
last gives each phase's kernel launches (every wrapper's count). It
runs on a card only: without one it exits non-zero and prints no result.
"""
from __future__ import annotations

import copy
import json
import math
import os
import sys

import numpy as np
import torch

CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs",
                      "lrs2_RTFSNet_4_layer.yaml")
BASELINE_MS_PER_UTT = 57.8  # the reference paper's RTFS-Net-4 inference time
KEYS = ("metric", "value", "unit", "vs_baseline", "inference_ms_per_utt",
        "train_ms_per_step_b4", "train_utt_per_s_per_chip", "train_ms_per_step_b16",
        "train_utt_per_s_per_chip_b16")


def launch_counts():
    """Every kernel wrapper's count of launches, by label (``ops.kernels.KERNELS``)."""
    from .ops.kernels import KERNELS

    return {k.label: getattr(k.module, k.counter) for k in KERNELS}


def launched(fn):
    """``fn()`` and the kernel launches it made, by kernel."""
    before = launch_counts()
    out = fn()
    return out, {k: n - before[k] for k, n in launch_counts().items()}


def request_pool(batch, samples, lip_channels, rng, pool=4):
    """``pool`` (batch, samples) mixtures, then a (batch, lip_channels,
    frames) lip embedding scaled by 0.1, from ``rng``, as numpy arrays
    (``bench.py:47-54``)."""
    mixes = [rng.standard_normal((batch, samples)).astype(np.float32) for _ in range(pool)]
    frames = int(round(samples / 16000 * 25))
    mouth = rng.standard_normal((batch, lip_channels, frames)).astype(np.float32) * 0.1
    return mixes, mouth


def serving_ms(model, mix_pool, mouth, device, iters=6):
    """Min ms of ``separate`` in bfloat16 on the whole batch over ``iters``
    calls, call i on ``mix_pool[i % len] + i·1e-6`` (one warm-up first),
    after a check that a float32 slice of up to 8 gives finite output:
    ``iters + 2`` forwards in all."""
    from .utils.profiling import timed
    from .utils.separator import separate

    out = separate(model, mix_pool[0][:8], mouth[:8], device=device)
    if not bool(torch.isfinite(out).all()):
        raise RuntimeError("bench: non-finite output")
    return timed(lambda m: separate(model, m, mouth, device=device, dtype=torch.bfloat16),
                 lambda i: (mix_pool[i % len(mix_pool)] + float(i) * 1e-6,),
                 iters=iters)["min_ms"]


def train_ms(conf, model, mix_pool, mouth, batch, device, iters=6):
    """Min ms of ``System.train_step`` in bfloat16 at ``batch`` over
    ``iters`` steps (one warm-up first) of a copy of ``model`` with the
    config's optimizer, the mixture as its own target (``bench.py:83-118``),
    the training state carried from step to step: ``iters + 1`` steps."""
    from .losses import PITLossWrapper, pairwise_neg_sisdr, pairwise_neg_snr
    from .system import System, make_optimizer
    from .utils.profiling import timed

    trained = copy.deepcopy(model)
    system = System(trained, make_optimizer(trained.parameters(), **conf["optim"]),
                    {"train": PITLossWrapper(pairwise_neg_snr),
                     "val": PITLossWrapper(pairwise_neg_sisdr)},
                    compute_dtype=torch.bfloat16)
    generator = torch.Generator(device=device).manual_seed(1)
    tmouth = mouth[:batch]

    def step(m):
        return system.train_step((m, m[:, None], tmouth), generator)["loss"]

    return timed(step, lambda i: (mix_pool[i % len(mix_pool)][:batch] + float(i) * 1e-6,),
                 iters=iters)["min_ms"]


def run(conf, device="cuda", batch: int = 128, samples: int = 32000,
        train_batches=(4, 16), iters: int = 6):
    """The benchmark of ``conf`` (a YAML config) on ``device``: returns the
    result (``KEYS``) and the kernel launches of each phase."""
    from .models import build_model, resolve_device

    device = resolve_device(device)
    audionet = conf["audionet"]
    model = build_model(audionet, device=device)
    mixes, mouth = request_pool(batch, samples, audionet["pretrained_vout_chan"],
                                np.random.default_rng(0))
    mix_pool = [torch.from_numpy(m).to(device) for m in mixes]
    mouth = torch.from_numpy(mouth).to(device)

    serve_ms, launches = launched(lambda: serving_ms(model, mix_pool, mouth, device, iters))
    launches = {"serving": launches}
    train_times = {}
    for B in train_batches:
        train_times[B], launches[f"train_b{B}"] = launched(
            lambda: train_ms(conf, model, mix_pool, mouth, B, device, iters))
    ms_per_utt = serve_ms / batch
    b4, b16 = train_times[train_batches[0]], train_times[train_batches[-1]]
    result = {
        "metric": "rtfsnet4_bf16_2s_utterances_per_sec_per_chip",
        "value": round(batch / serve_ms * 1e3, 2),
        "unit": "utt/s",
        "vs_baseline": round(BASELINE_MS_PER_UTT / ms_per_utt, 2),
        "inference_ms_per_utt": round(ms_per_utt, 3),
        "train_ms_per_step_b4": round(b4, 1),
        "train_utt_per_s_per_chip": round(train_batches[0] / (b4 / 1e3), 2),
        "train_ms_per_step_b16": round(b16, 1),
        "train_utt_per_s_per_chip_b16": round(train_batches[-1] / (b16 / 1e3), 2),
    }
    return result, launches


def main():
    if not torch.cuda.is_available():
        print("bench: no CUDA device; the benchmark runs on a card only", file=sys.stderr)
        return 2
    import yaml

    with open(CONFIG) as f:
        conf = yaml.safe_load(f)
    result, launches = run(conf)
    if not all(math.isfinite(v) for v in result.values() if not isinstance(v, str)):
        raise RuntimeError(f"bench: non-finite result {result}")
    print("launches " + json.dumps(launches))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
