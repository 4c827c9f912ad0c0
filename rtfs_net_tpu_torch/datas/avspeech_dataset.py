"""AVSpeech dataset over JSON manifests (``rtfs_net_tpu/datas/avspeech_dataset.py``,
copied; reference: ``src/datas/avspeech_dataset.py``).

Manifest layout (built by ``data_preprocess/preprocess_*.py``):
``<json_dir>/{mix,s1,s2}.json`` where mix entries are
``[wav_path, n_samples]`` and source entries are
``[wav_path, mouth_npz_path, n_samples]``.

Semantics preserved: n_src=1 duplicates each mixture once per speaker with
that speaker's mouth track (target-speaker extraction); utterances shorter
than ``segment`` are dropped in train mode; hard 2 s crop (n_src=1 crops
in test mode too, matching ``avspeech_dataset.py:137`` — that is the path
the published results used); optional mixture-std normalization.

Deviation: the reference's n_src=2 branch slices ``sources[: sr*2]`` on
the *source* axis (a no-op) and crops the test mixture; we crop both on
the sample axis in train mode and leave test full-length.
"""
from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from . import wavio
from .transform import get_preprocessing_pipelines

EPS = 1e-8


def normalize_wav(wav: np.ndarray, std: Optional[np.ndarray] = None) -> np.ndarray:
    mean = wav.mean(-1, keepdims=True)
    if std is None:
        std = wav.std(-1, keepdims=True)
    return (wav - mean) / (std + EPS)


class AVSpeechDataset:
    def __init__(
        self,
        json_dir: str,
        n_src: int = 2,
        sample_rate: int = 8000,
        segment: Optional[float] = 4.0,
        normalize_audio: bool = False,
        return_src_path: bool = False,
        audio_only: bool = False,
        device_normalize_video: bool = False,
    ):
        if json_dir is None:
            raise ValueError("JSON DIR is None!")
        if n_src not in (1, 2):
            raise ValueError(f"{n_src} is not in [1, 2]")
        self.json_dir = json_dir
        self.n_src = n_src
        self.sample_rate = sample_rate
        self.normalize_audio = normalize_audio
        self.return_src_path = return_src_path
        self.audio_only = audio_only
        self.seg_len = None if segment is None else int(segment * sample_rate)
        self.test = self.seg_len is None
        self.device_normalize_video = device_normalize_video
        self.video_pipeline = get_preprocessing_pipelines(
            device_normalize=device_normalize_video)[
            "train" if segment is not None else "val"
        ]

        with open(os.path.join(json_dir, "mix.json")) as f:
            mix_infos = json.load(f)
        sources_infos = []
        for source in ["s1", "s2"]:
            with open(os.path.join(json_dir, f"{source}.json")) as f:
                sources_infos.append(json.load(f))

        self.mix, self.sources = [], []
        drop_utt = drop_len = 0
        if n_src == 1:
            orig_len = len(mix_infos) * 2
            for i in range(len(mix_infos)):
                if not self.test and mix_infos[i][1] < self.seg_len:
                    drop_utt += 1
                    drop_len += mix_infos[i][1]
                    continue
                for src_inf in sources_infos:
                    self.mix.append(mix_infos[i])
                    self.sources.append(src_inf[i])
        else:
            orig_len = len(mix_infos)
            for i in range(len(mix_infos)):
                if not self.test and mix_infos[i][1] < self.seg_len:
                    drop_utt += 1
                    drop_len += mix_infos[i][1]
                    continue
                self.mix.append(mix_infos[i])
                self.sources.append([src_inf[i] for src_inf in sources_infos])
        if drop_utt:
            print(f"Drop {drop_utt} utts({drop_len / sample_rate / 3600:.2f} h) "
                  f"from {orig_len} (shorter than {self.seg_len} samples)")

    def __len__(self):
        return len(self.mix)

    def _read_wav(self, path, stop):
        data, sr = wavio.read(path, start=0, stop=stop, dtype="float32")
        return data

    def _read_mouth(self, npz_path):
        frames = np.load(npz_path)["data"]
        out = self.video_pipeline(frames)
        if self.device_normalize_video and self.test:
            return np.ascontiguousarray(out)  # raw uint8, 1 byte/pixel
        # train/val pipelines already emit float32 (FusedNormalize)
        return out.astype(np.float32, copy=False)

    def __getitem__(self, idx: int):
        stop = self.seg_len
        key = os.path.basename(self.mix[idx][0])
        crop = self.sample_rate * 2

        if self.n_src == 1:
            mixture = self._read_wav(self.mix[idx][0], stop)
            source = self._read_wav(self.sources[idx][0], stop)
            if self.normalize_audio:
                m_std = mixture.std(-1, keepdims=True)
                mixture = normalize_wav(mixture, m_std)
                source = normalize_wav(source, m_std)
            out = (mixture[:crop], source[:crop])
            if not self.audio_only:
                mouth = self._read_mouth(self.sources[idx][1])
                out += (mouth[None],)  # (1, T_v, 88, 88)
            out += (key,)
            if self.return_src_path:
                out += (self.sources[idx][0],)
            return out

        mixture = self._read_wav(self.mix[idx][0], stop)
        sources = np.stack([self._read_wav(s[0], stop) for s in self.sources[idx]])
        if self.normalize_audio:
            m_std = mixture.std(-1, keepdims=True)
            mixture = normalize_wav(mixture, m_std)
            sources = normalize_wav(sources, m_std)
        out = (mixture[:crop], sources[:, :crop] if not self.test else sources)
        if not self.audio_only:
            mouths = np.stack([self._read_mouth(s[1]) for s in self.sources[idx]])
            out += (mouths,)
        out += (key,)
        return out
