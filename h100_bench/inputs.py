"""Inputs made from ``--seed``, on the host, in bulk.

A request is a (B, samples) 16 kHz mixture and its speaker's (B, 1, frames,
size, size) mouth-ROI frames, float32 as the validation pipeline hands them
over (grey levels in [0, 1), normalised by the LRS2 mean 0.421 and deviation
0.165). Each source is white noise; the target has deviation
``source_std``, and the mixture adds one interferer at a target-to-
interferer ratio drawn per utterance uniformly from ``snr_db`` (dB).
Set-up makes a pool of ``pool`` mixtures and ``frame_pool`` frame batches;
call i takes mixture i mod ``pool``, each utterance's first sample plus
i·1e-6, and frame batch i mod ``frame_pool``, so that no two calls share
their inputs (after ``rtfs_net_tpu_torch/bench.py:request_pool``) while
every seed does the same work. The offset is written into the pool's own
mixture, a column and not a copy, so that the window holds no host work
that a caller would not do.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

MOUTH_MEAN, MOUTH_STD = 0.421, 0.165


def stream(seed: int, *tags: int) -> np.random.Generator:
    """An independent generator for ``seed`` and a purpose."""
    return np.random.default_rng(np.random.SeedSequence([seed % 2 ** 63, *tags]))


def torch_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed for a ``torch.Generator`` from ``seed`` and a purpose."""
    return int(np.random.SeedSequence([seed % 2 ** 63, *tags]).generate_state(1, np.uint64)[0]
               >> np.uint64(1))


class Pool:
    """The request pool of one run: ``call(i)`` gives call i's
    (mixture, target, frames) as numpy arrays."""

    def __init__(self, traffic: Dict, seed: int):
        B, n = traffic["batch"], int(traffic["seconds_of_audio"] * traffic["sample_rate"])
        rng = stream(seed, 1)
        std = traffic.get("source_std", 0.1)
        self.targets: List[np.ndarray] = []
        self.mixes: List[np.ndarray] = []
        self.first: List[np.ndarray] = []  # each mixture's first column, unstamped
        lo, hi = traffic["snr_db"]
        for _ in range(traffic["pool"]):
            src = rng.standard_normal((2, B, n), dtype=np.float32) * np.float32(std)
            gain = (10.0 ** (-rng.uniform(lo, hi, (B, 1)) / 20.0)).astype(np.float32)
            self.targets.append(src[0])
            self.mixes.append(src[0] + gain * src[1])
            self.first.append(self.mixes[-1][:, 0].copy())
        shape = (B, 1, traffic["frames"], traffic["frame_size"], traffic["frame_size"])
        self.frames = []
        for _ in range(traffic["frame_pool"]):
            f = rng.random(shape, dtype=np.float32)
            f -= np.float32(MOUTH_MEAN)
            f /= np.float32(MOUTH_STD)
            self.frames.append(f)

    @staticmethod
    def stamp(i: int) -> np.float32:
        """What call i adds to each utterance's first sample."""
        return np.float32(i * 1e-6)

    def call(self, i: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Call i's (mixture, target, frames): the pool's own arrays, the
        mixture stamped for call i, valid until the next ``call``."""
        p = i % len(self.mixes)
        self.mixes[p][:, 0] = self.first[p] + self.stamp(i)
        return self.mixes[p], self.targets[p], self.frames[i % len(self.frames)]
