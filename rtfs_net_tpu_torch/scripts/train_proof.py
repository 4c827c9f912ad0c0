"""Training proof (``scripts/train_proof.py`` of the JAX side): the full
RTFS-Net-4 (``configs/lrs2_RTFSNet_4_layer.yaml``, weights from seed 0)
overfits a small synthetic separation task, and the validation SI-SDR
must rise by more than 5 dB:

    python -m rtfs_net_tpu_torch.scripts.train_proof [--device cpu]

The evidence that the flagship model *learns* under the port's training
stack (forward, PIT neg-SNR, checkpointed backward through K2 and K3,
the config's AdamW): 200 ``System.train_step`` calls in float32 at B = 4
on one batch of four 2 s speech-like targets, each mixed with a
speech-like interferer, with (4, 512, 50) lip embeddings of N(0, 0.1²)
(the same arrays as the JAX script, from ``numpy.random.default_rng(0)``);
dropout masks from a ``torch.Generator`` seeded 1. Every 25 steps it
prints the step's train SNR and the validation SI-SDR (``val_step``, K1
and K3), then the improvement, ms per step (host clock around each run of
25 steps, ended by a synchronise) and the kernel launches, and a last
line of JSON. It exits 1 unless the improvement is above 5.0 dB, 2 when
asked for a card and there is none.

Precision: as ``rtfs_net_tpu_torch.train``, PyTorch's defaults (cuDNN
convolutions may use TF32, matmuls run in full float32); it changes no
global setting.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from . import config_path, device_name, device_or_none, load_config, synchronize

CONFIG = "lrs2_RTFSNet_4_layer"
STEPS, BATCH, SAMPLES, FRAMES = 200, 4, 32000, 50
LOG_EVERY = 25
MIN_GAIN_DB = 5.0


def speechlike(rng, n, sr=16000, f0=150.0):
    t = np.arange(n) / sr
    mod = f0 + 40 * np.sin(2 * np.pi * 2.1 * t + rng.uniform(0, 6))
    env = np.clip(np.sin(2 * np.pi * rng.uniform(2, 4) * t + rng.uniform(0, 6)), 0, None)
    sig = np.sin(2 * np.pi * np.cumsum(mod) / sr) * env
    return (sig + 0.05 * rng.standard_normal(n)).astype(np.float32)


def proof_batch(batch=BATCH, samples=SAMPLES, lip_channels=512, frames=FRAMES):
    """(mix, targets, lip embedding) as numpy: speech-like targets at f0 =
    130 + 30 i, interferers at 280 + 25 i, from ``default_rng(0)``
    (``scripts/train_proof.py:39-45``)."""
    rng = np.random.default_rng(0)
    target = np.stack([speechlike(rng, samples, f0=130 + 30 * i) for i in range(batch)])
    noise = np.stack([speechlike(rng, samples, f0=280 + 25 * i) for i in range(batch)])
    mouth = rng.standard_normal((batch, lip_channels, frames)).astype(np.float32) * 0.1
    return target + noise, target[:, None, :], mouth


def make_system(model, optim, **kwargs):
    """``System`` with the train loss PIT neg-SNR and the validation loss
    PIT neg-SI-SDR, the optimizer ``make_optimizer(**optim)``."""
    from ..losses import PITLossWrapper, pairwise_neg_sisdr, pairwise_neg_snr
    from ..system import System, make_optimizer

    return System(model, make_optimizer(model.parameters(), **optim),
                  {"train": PITLossWrapper(pairwise_neg_snr),
                   "val": PITLossWrapper(pairwise_neg_sisdr)}, **kwargs)


def fit(system, batch, steps, generator, log_every, validate=True, log=print):
    """``steps`` train steps on one ``batch`` (tensors on the model's
    device). With ``validate``, the validation SI-SDR before the first step
    and after every ``log_every`` steps; ``log`` (``print``, or None for
    silence) gets a line after every ``log_every`` steps. Returns every
    step's train loss, the validation curve as (step, dB) pairs and ms per
    train step (host clock around each run of steps, ended by a
    synchronise)."""
    device = batch[0].device
    losses, curve = [], []
    if validate:
        curve.append((0, -float(system.val_step(batch)["val_loss"])))
    spent, t_start = 0.0, time.perf_counter()
    for start in range(0, steps, log_every):
        n = min(log_every, steps - start)
        synchronize(device)
        t0 = time.perf_counter()
        for _ in range(n):
            losses.append(system.train_step(batch, generator)["loss"])
        synchronize(device)
        spent += time.perf_counter() - t0
        msg = f"step {start + n}: train {-float(losses[-1]):.2f} dB SNR"
        if validate:
            curve.append((start + n, -float(system.val_step(batch)["val_loss"])))
            msg += f", val {curve[-1][1]:.2f} dB SI-SDR"
        if log is not None:
            log(f"{msg} ({time.perf_counter() - t_start:.0f}s)", flush=True)
    return {"losses": [float(x) for x in losses], "val_db": curve,
            "ms_per_step": spent / steps * 1e3}


def run(device, conf=None, steps=STEPS, batch=BATCH, samples=SAMPLES, log=print):
    """The proof on ``device``: returns ``fit``'s result with the SI-SDR
    improvement (``improvement_db``) and the kernel launches."""
    import torch

    from ..bench import launched
    from ..models import build_model

    conf = conf or load_config(CONFIG)
    model = build_model(conf, device=device)
    system = make_system(model, conf["optim"])
    arrays = proof_batch(batch, samples, conf["audionet"]["pretrained_vout_chan"])
    tensors = tuple(torch.from_numpy(a).to(device) for a in arrays)
    generator = torch.Generator(device=device).manual_seed(1)
    out, launches = launched(lambda: fit(system, tensors, steps, generator, LOG_EVERY, log=log))
    out["improvement_db"] = out["val_db"][-1][1] - out["val_db"][0][1]
    out["launches"] = launches
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    device = device_or_none("train_proof", p.parse_args(argv).device)
    if device is None:
        return 2
    out = run(device)
    v0, v1 = out["val_db"][0][1], out["val_db"][-1][1]
    print(f"SI-SDR improvement after {STEPS} steps: {out['improvement_db']:.2f} dB "
          f"({v0:.2f} -> {v1:.2f}); {out['ms_per_step']:.1f} ms/step; "
          f"launches {json.dumps(out['launches'])}", flush=True)
    print(json.dumps({"tool": "train_proof", "config": config_path(CONFIG),
                      "device": device_name(device), **{k: out[k] for k in (
                          "improvement_db", "val_db", "ms_per_step", "launches")}}))
    if not out["improvement_db"] > MIN_GAIN_DB:
        print(f"TRAINING PROOF FAILED: expected > {MIN_GAIN_DB} dB", file=sys.stderr)
        return 1
    print("TRAINING PROOF PASSED")
    return 0


if __name__ == "__main__":
    sys.exit(main())
