"""Host data-loader throughput (``scripts/bench_loader.py`` of the JAX
side): how many utterances a second ``datas.loader.DataLoader`` decodes
and delivers to the card, over worker counts:

    python -m rtfs_net_tpu_torch.scripts.bench_loader [--n 256] [--workers 1 4 8 16]

Builds a synthetic on-disk set (real PCM16 wav files, compressed npz
mouth tracks and ``{mix,s1,s2}.json`` manifests, the format the manifest
builders write; the JAX script's files from ``numpy.random.default_rng(0)``),
then times whole epochs through ``datas.AVSpeechDataset`` (ranged WAV
read, npz inflate, video transform, collate) for three variants: float
video, uint8 video normalised on the device, audio only. For each: the
in-process decode rate (no loader, up to 64 items), then per worker count
a warm epoch (worker spawn and page cache, paid once a run) and a timed
one, each batch uploaded to the device as the trainer uploads it (pinned,
non-blocking: ``system.trainer.upload_batch``) and the epoch ended by a
synchronise. The last line is JSON with every rate and ``best_av``, to be
set beside the trainer's demand (the bench's ``train_utt_per_s_per_chip``).
Runs on a card unless ``--device cpu``; without one it exits 2.

This module imports no torch at the top: the loader's spawned workers
import it again.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

from . import device_name, device_or_none, synchronize
from ..datas import AVSpeechDataset, wavio
from ..datas.loader import DataLoader

VARIANTS = (("av_float", {"audio_only": False}),
            ("av_uint8", {"audio_only": False, "device_normalize_video": True}),
            ("audio_only", {"audio_only": True}))


def make_dataset(root: str, n: int, seconds: float = 3.0, fps: int = 25,
                 sr: int = 16000) -> str:
    rng = np.random.default_rng(0)
    L = int(seconds * sr)
    tv = int(seconds * fps)
    mix, s1, s2 = [], [], []
    for i in range(n):
        paths = []
        for name in ("mix", "s1", "s2"):
            p = os.path.join(root, f"{name}_{i}.wav")
            wavio.write(p, rng.standard_normal(L).astype(np.float32) * 0.1, sr)
            paths.append(p)
        mouths = []
        for name in ("m1", "m2"):
            mp = os.path.join(root, f"{name}_{i}.npz")
            # a smooth-ish uint8 mouth track that compresses like video
            frames = (rng.random((tv, 96, 96)) * 48 + 100).astype(np.uint8)
            np.savez_compressed(mp, data=frames)
            mouths.append(mp)
        mix.append([paths[0], L])
        s1.append([paths[1], mouths[0], L])
        s2.append([paths[2], mouths[1], L])
    for name, data in (("mix", mix), ("s1", s1), ("s2", s2)):
        with open(os.path.join(root, f"{name}.json"), "w") as f:
            json.dump(data, f)
    return root


def run_epoch(loader, device=None) -> float:
    """One full epoch through the loader, each batch uploaded to
    ``device`` (None: left on the host); returns utterances/second."""
    from ..system.trainer import upload_batch

    n_utts = 0
    t0 = time.perf_counter()
    for batch in loader:
        if device is not None:
            upload_batch(batch, device)
        n_utts += batch[0].shape[0]
    if device is not None:
        synchronize(device)
    return n_utts / (time.perf_counter() - t0)


def bench(root, device, workers, batch_size=16, log=print):
    """Every rate of the three variants, by ``<variant>_inproc`` and
    ``<variant>_w<workers>``."""
    results = {}
    for dn, kwargs in VARIANTS:
        ds = AVSpeechDataset(root, n_src=1, sample_rate=16000, segment=2.0,
                             normalize_audio=False, **kwargs)
        # raw per-core decode rate, no loader machinery
        n_probe = min(64, len(ds))
        ds[0]
        t0 = time.perf_counter()
        for i in range(n_probe):
            ds[i]
        inproc = n_probe / (time.perf_counter() - t0)
        results[f"{dn}_inproc"] = inproc
        log(f"{dn:12s} in-proc       {inproc:8.1f} utt/s", flush=True)
        for w in workers:
            loader = DataLoader(ds, batch_size=batch_size, shuffle=True, num_workers=w,
                                drop_last=True)
            try:
                run_epoch(loader, device)  # warm: worker spawn and page cache
                ups = run_epoch(loader, device)
            finally:
                loader.close()
            results[f"{dn}_w{w}"] = ups
            log(f"{dn:12s} workers={w:3d}  {ups:8.1f} utt/s [{loader.worker_type}]",
                flush=True)
    return results


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--n", type=int, default=256,
                   help="wav files (x2 speakers = 2n utterances/epoch)")
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--workers", type=int, nargs="+", default=[1, 4, 8, 16])
    p.add_argument("--keep-dir", default=None,
                   help="reuse/create the dataset here instead of a tempdir")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = device_or_none("bench_loader", args.device)
    if device is None:
        return 2
    with tempfile.TemporaryDirectory() as tmp:
        root = args.keep_dir or tmp
        os.makedirs(root, exist_ok=True)
        if not os.path.exists(os.path.join(root, "mix.json")):
            make_dataset(root, args.n)
        results = bench(root, device, args.workers, args.batch_size)
    best_av = max(v for k, v in results.items() if k.startswith("av_"))
    print(json.dumps({"tool": "bench_loader", "metric": "loader_utt_per_s",
                      "device": device_name(device), "best_av": best_av,
                      "nproc": os.cpu_count(), **results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
