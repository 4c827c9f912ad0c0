"""Mouth-ROI video transforms (``rtfs_net_tpu/datas/transform.py``, copied;
reference: ``src/datas/transform.py``).

numpy-native (cv2 only needed for RGB->gray conversion, which the LRS/Vox
mouth crops don't use — they ship grayscale npz). Train: Normalize(0,255)
-> RandomCrop(88x88) -> HFlip(0.5) -> Normalize(.421,.165); val/test:
CenterCrop instead of random ops.
"""
from __future__ import annotations

import random
from typing import Sequence, Tuple

import numpy as np


class Compose:
    def __init__(self, preprocess: Sequence):
        self.preprocess = list(preprocess)

    def __call__(self, sample):
        for t in self.preprocess:
            sample = t(sample)
        return sample


class RgbToGray:
    def __call__(self, frames):
        import cv2

        return np.stack([cv2.cvtColor(f, cv2.COLOR_RGB2GRAY) for f in frames], axis=0)


class Normalize:
    def __init__(self, mean: float, std: float):
        self.mean = mean
        self.std = std

    def __call__(self, frames):
        return (frames - self.mean) / self.std


class CenterCrop:
    def __init__(self, size: Tuple[int, int]):
        self.size = size

    def __call__(self, frames):
        t, h, w = frames.shape
        th, tw = self.size
        dh = int(round(h - th) / 2.0)
        dw = int(round(w - tw) / 2.0)
        return frames[:, dh:dh + th, dw:dw + tw]


class RandomCrop:
    def __init__(self, size: Tuple[int, int]):
        self.size = size

    def __call__(self, frames):
        t, h, w = frames.shape
        th, tw = self.size
        dh = random.randint(0, h - th)
        dw = random.randint(0, w - tw)
        return frames[:, dh:dh + th, dw:dw + tw]


class HorizontalFlip:
    def __init__(self, flip_ratio: float):
        self.flip_ratio = flip_ratio

    def __call__(self, frames):
        if random.random() < self.flip_ratio:
            return np.ascontiguousarray(frames[:, :, ::-1])
        return frames


# net affine of the reference chain Normalize(0,255) -> Normalize(.421,.165):
# x/255/0.165 - 0.421/0.165 == (x - MOUTH_MEAN) / MOUTH_STD on raw uint8
MOUTH_MEAN = 0.421 * 255.0
MOUTH_STD = 0.165 * 255.0


class FusedNormalize:
    """The whole normalize chain as ONE float32 multiply-add.

    The reference applies Normalize(0,255) before the crops and
    Normalize(.421,.165) after (``transform.py:151-167``) — two float64
    passes over the uncropped 96x96 frames. Normalization commutes with
    crop/flip, so fusing it into a single float32 affine placed AFTER the
    crops touches 88x88 pixels once; this host decode path gates training
    throughput (profiled: the two-Normalize chain was ~47% of AV sample
    decode)."""

    def __init__(self, mean: float = MOUTH_MEAN, std: float = MOUTH_STD):
        self.scale = np.float32(1.0 / std)
        self.shift = np.float32(-mean / std)

    def __call__(self, frames):
        return frames.astype(np.float32) * self.scale + self.shift


def get_preprocessing_pipelines(device_normalize: bool = False):
    """Reference pipelines (``transform.py:151-167``), with the two
    Normalize stages fused into one post-crop float32 affine (identical
    values, see FusedNormalize). With ``device_normalize=True`` the
    val/test pipelines keep frames as raw uint8 (crop only) so the
    host->device transfer carries 1 byte/pixel; apply ``normalize_mouths``
    on-device after upload."""
    crop_size = (88, 88)
    pipelines = {
        "train": Compose([
            RandomCrop(crop_size),
            HorizontalFlip(0.5),
            FusedNormalize(),
        ]),
        "val": Compose([CenterCrop(crop_size), FusedNormalize()]),
        "test": Compose([CenterCrop(crop_size), FusedNormalize()]),
    }
    if device_normalize:
        crop_only = Compose([CenterCrop(crop_size)])
        pipelines["val"] = crop_only
        pipelines["test"] = crop_only
    return pipelines


def normalize_mouths(frames):
    """The host Normalize chain, for uint8 frames from the
    ``device_normalize`` pipelines, on numpy arrays; float inputs pass
    through unchanged (already normalized on host)."""
    if frames.dtype == np.uint8:
        return (frames.astype(np.float32) - MOUTH_MEAN) / MOUTH_STD
    return frames
