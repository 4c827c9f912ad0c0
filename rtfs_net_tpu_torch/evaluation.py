"""Batched, bucketed evaluation engine (``rtfs_net_tpu/evaluation.py:102-211``;
reference ``test.py:127-141`` evaluates batched at ``batch_size*2``):

* utterances are grouped by padded length (``bucket``-sample granularity;
  audio zero-padded, mouth frames padded to the matching 25 fps count by
  ``_pad_mouth``);
* each group runs as batches of ``eval_batch_size``; a group's last batch
  runs at its true size;
* rows are cropped back to their true length before the PIT reorder
  (under the SDR type of the configured loss) and scoring, so every metric
  is per utterance and unpadded;
* scoring (PIT reorder, SI-SNR/SDR/PESQ/STOI, wav examples) runs in a
  host thread pool while the model's device computes the next batch.

The forward runs on the model's device under ``torch.inference_mode()``;
one device (data parallel is a later slice).
"""
from __future__ import annotations

import itertools
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .datas import wavio
from .datas.transform import MOUTH_MEAN, MOUTH_STD
from .metrics.allwrapper import _np_neg_sdr


def _loss_sdr_type(loss_func) -> str:
    """SDR flavor of the configured PIT eval loss, so the reorder happens
    under the objective the reference reorders with (reference
    test.py:56-58); sisdr, the reference's eval loss, when the loss is not a
    wrapped pairwise SDR."""
    inner = getattr(loss_func, "loss_func", loss_func)
    kw = getattr(inner, "keywords", None) or {}
    return kw.get("sdr_type", "sisdr")


def _np_reorder(est: np.ndarray, src: np.ndarray,
                sdr_type: str = "sisdr") -> np.ndarray:
    """Reorder estimate rows to the PIT-best permutation against the
    sources (reference test.py:56-58 return_ests reorder)."""
    n_src = src.shape[0]
    if n_src == 1:
        return est
    pairwise = np.empty((n_src, n_src))
    for i in range(n_src):
        for j in range(n_src):
            pairwise[i, j] = _np_neg_sdr(est[i].astype(np.float64),
                                         src[j].astype(np.float64), sdr_type)
    best_perm = min(itertools.permutations(range(n_src)),
                    key=lambda p: np.mean([pairwise[i, pi]
                                           for i, pi in enumerate(p)]))
    # est[i] matches src[best_perm[i]] -> place est rows in source order
    out = np.empty_like(est)
    for i, pi in enumerate(best_perm):
        out[pi] = est[i]
    return out


@dataclass
class _Record:
    idx: int
    mix: np.ndarray        # (L,)
    sources: np.ndarray    # (n_src, L)
    mouths: Optional[np.ndarray]
    key: str
    length: int


def _pad_mouth(mouth: np.ndarray, tv: int) -> np.ndarray:
    """Pad (or crop) the frame axis (-3) to ``tv`` frames. Float frames
    (normalized on the host) pad with 0.0; uint8 frames (normalized on the
    device) pad with the mean pixel, so both normalize to the same zero
    frame."""
    t = mouth.shape[-3]
    if t == tv:
        return mouth
    if t > tv:
        sl = [slice(None)] * mouth.ndim
        sl[-3] = slice(0, tv)
        return mouth[tuple(sl)]
    pad = [(0, 0)] * mouth.ndim
    pad[-3] = (0, tv - t)
    if mouth.dtype == np.uint8:
        return np.pad(mouth, pad, constant_values=int(round(MOUTH_MEAN)))
    return np.pad(mouth, pad)


def normalize_mouths(frames: torch.Tensor) -> torch.Tensor:
    """The host's Normalize chain for uint8 frames uploaded raw (the
    ``device_normalize`` pipelines), on the device; float frames, already
    normalized, pass through."""
    if frames.dtype == torch.uint8:
        return (frames.float() - MOUTH_MEAN) / MOUTH_STD
    return frames


def forward_batch(model, video_apply: Optional[Callable], mix: torch.Tensor,
                  mouths: Optional[torch.Tensor]) -> torch.Tensor:
    """One batch's forward: (B, L) mixtures [+ (B, 1, T_v, H, W) frames]
    -> (B, n_src, L)."""
    emb = None if mouths is None else video_apply(mouths)
    return model(mix, emb)


class _Overlap:
    """How the host's scoring and the device's batches waited on each
    other: the time the scoring pool had nothing to do (from the start of
    the run to its last job), and the scoring time of each utterance."""

    def __init__(self):
        self.lock = threading.Lock()
        self.outstanding = 0
        self.idle_since = time.perf_counter()
        self.idle_s = 0.0
        self.score_s: List[float] = []

    def submitted(self):
        with self.lock:
            if self.outstanding == 0:
                self.idle_s += time.perf_counter() - self.idle_since
            self.outstanding += 1

    def finished(self, seconds: float):
        with self.lock:
            self.score_s.append(seconds)
            self.outstanding -= 1
            if self.outstanding == 0:
                self.idle_since = time.perf_counter()


def run_batched_eval(
    model: torch.nn.Module,
    test_set,
    metrics,
    loss_func,
    video_apply: Optional[Callable],
    bucket: int,
    eval_batch_size: int,
    sample_rate: int,
    n_save_ex: int = 0,
    examples_dir: Optional[str] = None,
    fps: int = 25,
    progress_every: int = 50,
    metric_workers: int = 8,
) -> Dict:
    """Evaluate ``test_set`` (items ``(mix, sources, [mouths], key)``) with
    ``model`` on its device, feeding each utterance to ``metrics`` (an
    ``ALLMetricsTracker``). ``video_apply`` maps a batch of frames on the
    device to the lip embedding. Returns the run's timings:

    * ``batch_ms``: each batch's forward, by CUDA events on a card
      (``batch_clock`` "cuda_events"), else by the host clock ("host");
    * ``wait_for_device_s``: the host blocked on the batches' results;
    * ``scoring_idle_s``: the scoring pool had nothing to score, waiting on
      the device (and the host's batching);
    * ``drain_s``: scoring still running after the last batch came back,
      when the device has nothing left to do;
    * ``score_ms_per_utt``: one utterance's scoring (PESQ, STOI, SI-SNR,
      SDR), median over the run;
    * ``utterances``, ``batches``, ``wall_s``.
    """
    device = next(model.parameters()).device
    on_card = device.type == "cuda"
    reorder_sdr = _loss_sdr_type(loss_func)
    overlap = _Overlap()
    n_done = 0
    done_lock = threading.Lock()

    def score(r: _Record, est: np.ndarray):
        nonlocal n_done
        t0 = time.perf_counter()
        try:
            est = _np_reorder(est, r.sources, reorder_sdr)
            metrics(mix=r.mix, clean=r.sources, estimate=est, key=r.key,
                    sample_rate=sample_rate)
            if examples_dir and r.idx < n_save_ex:
                for name, wav in (("est", est[0]), ("gt", r.sources[0]), ("mix", r.mix)):
                    wavio.write(os.path.join(examples_dir, f"{r.idx}_{name}.wav"), wav,
                                sample_rate)
        finally:
            overlap.finished(time.perf_counter() - t0)
        with done_lock:
            n_done += 1
            count = n_done
        if progress_every and count % progress_every == 0:
            print(f"[{count}/{len(test_set)}] {metrics.get_mean()}")

    events, batch_ms = [], []
    wait_s = 0.0
    futures = []
    t_start = time.perf_counter()

    def flush(pool, pad_len: int, recs: List[_Record]):
        nonlocal wait_s
        t0 = time.perf_counter()
        mix = np.stack([np.pad(r.mix, (0, pad_len - r.length)) for r in recs])
        mix = torch.from_numpy(mix.astype(np.float32, copy=False)).to(device)
        mouths = None
        if video_apply is not None and recs[0].mouths is not None:
            tv = -(-pad_len * fps // sample_rate)
            frames = np.stack([_pad_mouth(r.mouths, tv) for r in recs])
            if frames.dtype != np.uint8:  # uint8 uploads at 1 byte per pixel
                frames = frames.astype(np.float32)
            mouths = torch.from_numpy(frames).to(device)
        if on_card:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
        with torch.inference_mode():
            est = forward_batch(model, video_apply, mix, mouths)
        if on_card:
            end.record()
            events.append((start, end))
        t1 = time.perf_counter()
        est = est.float().cpu().numpy()
        wait_s += time.perf_counter() - t1
        if not on_card:
            batch_ms.append((time.perf_counter() - t0) * 1e3)
        # hand scoring to the pool; the device starts on the next batch
        for i, r in enumerate(recs):
            overlap.submitted()
            futures.append(pool.submit(score, r, est[i][:, : r.length]))

    with ThreadPoolExecutor(max_workers=max(1, metric_workers)) as pool:
        pending: Dict[int, List[_Record]] = {}
        for idx in range(len(test_set)):
            sample = test_set[idx]
            mix, sources = np.asarray(sample[0]), np.asarray(sample[1])
            mouths = np.asarray(sample[2]) if len(sample) > 3 else None
            key = sample[3] if len(sample) > 3 else sample[2]
            if sources.ndim == 1:
                sources = sources[None]
            length = mix.shape[-1]
            pad_len = -(-length // bucket) * bucket
            pending.setdefault(pad_len, []).append(
                _Record(idx, mix, sources, mouths, key, length))
            if len(pending[pad_len]) == eval_batch_size:
                flush(pool, pad_len, pending.pop(pad_len))
        for pad_len in sorted(pending):
            flush(pool, pad_len, pending[pad_len])
        t_last = time.perf_counter()
        for f in futures:
            f.result()  # propagate scoring exceptions
        drain_s = time.perf_counter() - t_last
    if on_card:
        batch_ms = [start.elapsed_time(end) for start, end in events]
    return {
        "utterances": len(futures), "batches": len(batch_ms),
        "wall_s": time.perf_counter() - t_start,
        "batch_ms": batch_ms, "batch_clock": "cuda_events" if on_card else "host",
        "wait_for_device_s": wait_s, "scoring_idle_s": overlap.idle_s, "drain_s": drain_s,
        "score_ms_per_utt": float(np.median(overlap.score_s)) * 1e3 if overlap.score_s else 0.0,
    }
