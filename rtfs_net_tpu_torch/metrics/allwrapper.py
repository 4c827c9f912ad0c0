"""Per-utterance metric tracker streaming to CSV
(``rtfs_net_tpu/metrics/allwrapper.py``, copied; reference:
``src/metrics/allwrapper.py``).

Computes SI-SNR(i) and SNR-SDR(i) with permutation-invariant matching
against the mixture baseline, plus PESQ and STOI, one row per utterance
with final mean/std rows. All metric values are stored as positive dB
improvements (the reference's CSV writes some columns negated —
accumulators here and there agree).

The per-utterance math runs in pure numpy on the host: these are tiny
O(n_src!·L) reductions, each of which would be a string of small kernel
launches on the card. The tracker is thread-safe — ``__call__`` computes outside the lock and
ingests under it — so the eval engine can score utterances in worker
threads while the device runs the next batch.
"""
from __future__ import annotations

import csv
import itertools
import threading

import numpy as np

from .pesq import pesq
from .stoi import stoi

_EPS = 1e-8


def _np_neg_sdr(est: np.ndarray, ref: np.ndarray, kind: str) -> float:
    """Single-pair negative SNR/SI-SDR/SD-SDR (matches losses/sdr.py
    semantics: zero-mean, eps 1e-8, 10log10; sdsdr scales the target but
    measures noise against the unscaled one)."""
    est = est - est.mean()
    ref = ref - ref.mean()
    if kind in ("sisdr", "sdsdr"):
        ref_scaled = (np.dot(est, ref) / (np.dot(ref, ref) + _EPS)) * ref
    else:  # snr
        ref_scaled = ref
    e = est - ref if kind in ("sdsdr", "snr") else est - ref_scaled
    ratio = (np.dot(ref_scaled, ref_scaled) + _EPS) / (np.dot(e, e) + _EPS)
    return -10.0 * np.log10(ratio)


def np_pit_neg_sdr(est: np.ndarray, ref: np.ndarray, kind: str) -> float:
    """PIT over n_src! permutations of (n_src, L) pairs, mean over
    sources; returns the best (lowest) negative SDR like PITLossWrapper."""
    n_src = ref.shape[0]
    pairwise = np.empty((n_src, n_src))
    for i in range(n_src):
        for j in range(n_src):
            pairwise[i, j] = _np_neg_sdr(est[i], ref[j], kind)
    best = np.inf
    for perm in itertools.permutations(range(n_src)):
        v = np.mean([pairwise[i, p] for i, p in enumerate(perm)])
        best = min(best, v)
    return float(best)


class ALLMetricsTracker:
    COLUMNS = ["snt_id", "sdr", "sdr_i", "si-snr", "si-snr_i", "pesq", "stoi"]

    def __init__(self, save_file: str = ""):
        self.all_sdrs = []
        self.all_sdrs_i = []
        self.all_sisnrs = []
        self.all_sisnrs_i = []
        self.all_pesqs = []
        self.all_stois = []
        self._fh = open(save_file, "w", newline="") if save_file else None
        self.writer = csv.DictWriter(self._fh, fieldnames=self.COLUMNS) if self._fh else None
        if self.writer:
            self.writer.writeheader()
        self._lock = threading.Lock()

    # ------------------------------------------------------------ compute
    def compute_row(self, mix, clean, estimate, key, sample_rate: int = 16000):
        """Pure computation, safe to run concurrently across threads."""
        mix = np.asarray(mix, dtype=np.float64)
        clean = np.asarray(clean, dtype=np.float64)
        estimate = np.asarray(estimate, dtype=np.float64)
        if clean.ndim == 1:
            clean = clean[None]
        if estimate.ndim == 1:
            estimate = estimate[None]

        sisnr = np_pit_neg_sdr(estimate, clean, "sisdr")
        mix_rep = np.stack([mix] * clean.shape[0], axis=0)
        sisnr_base = np_pit_neg_sdr(mix_rep, clean, "sisdr")
        sisnr_i = sisnr - sisnr_base

        sdr = np_pit_neg_sdr(estimate, clean, "snr")
        sdr_base = np_pit_neg_sdr(mix_rep, clean, "snr")
        sdr_i = sdr - sdr_base

        est0 = estimate[0].astype(np.float32)
        cln0 = clean[0].astype(np.float32)
        _pesq = pesq(est0, cln0, sample_rate)
        _stoi = stoi(cln0, est0, sample_rate, extended=False)

        return {
            "snt_id": key,
            "sdr": -sdr,
            "sdr_i": -sdr_i,
            "si-snr": -sisnr,
            "si-snr_i": -sisnr_i,
            "pesq": _pesq,
            "stoi": _stoi,
        }

    # ------------------------------------------------------------- ingest
    def ingest(self, row):
        with self._lock:
            self.key = row["snt_id"]
            if self.writer:
                self.writer.writerow(row)
            self.all_sdrs.append(row["sdr"])
            self.all_sdrs_i.append(row["sdr_i"])
            self.all_sisnrs.append(row["si-snr"])
            self.all_sisnrs_i.append(row["si-snr_i"])
            self.all_pesqs.append(row["pesq"])
            self.all_stois.append(row["stoi"])

    def __call__(self, mix, clean, estimate, key, sample_rate: int = 16000):
        """mix: (L,); clean/estimate: (n_src, L); key: utterance id."""
        self.ingest(self.compute_row(mix, clean, estimate, key, sample_rate))

    def get_mean(self):
        with self._lock:
            return {
                "sdr": float(np.mean(self.all_sdrs)),
                "sdr_i": float(np.mean(self.all_sdrs_i)),
                "si-snr": float(np.mean(self.all_sisnrs)),
                "si-snr_i": float(np.mean(self.all_sisnrs_i)),
                "pesq": float(np.nanmean(self.all_pesqs)),
                "stoi": float(np.mean(self.all_stois)),
            }

    def get_std(self):
        with self._lock:
            return {
                "sdr": float(np.std(self.all_sdrs)),
                "sdr_i": float(np.std(self.all_sdrs_i)),
                "si-snr": float(np.std(self.all_sisnrs)),
                "si-snr_i": float(np.std(self.all_sisnrs_i)),
                "pesq": float(np.nanstd(self.all_pesqs)),
                "stoi": float(np.std(self.all_stois)),
            }

    def final(self):
        if self.writer:
            mean = self.get_mean()
            std = self.get_std()
            with self._lock:
                self.writer.writerow({"snt_id": "avg", **{k: v for k, v in mean.items()}})
                self.writer.writerow({"snt_id": "std", **{k: v for k, v in std.items()}})
                self._fh.close()
                self.writer = None
