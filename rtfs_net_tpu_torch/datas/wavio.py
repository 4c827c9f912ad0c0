"""Minimal WAV reader/writer with ranged reads (``rtfs_net_tpu/datas/wavio.py``,
copied).

Replaces the reference's libsndfile dependency (``soundfile.read(path,
start=, stop=)``, ``avspeech_dataset.py:120-167``) for the PCM16/float32
mono files the AVSS datasets use. Ranged reads seek directly to the sample
offset, so 2 s training crops never load full utterances.
"""
from __future__ import annotations

import struct
from typing import Optional, Tuple

import numpy as np


def _find_chunks(f):
    riff, size, wave = struct.unpack("<4sI4s", f.read(12))
    if riff != b"RIFF" or wave != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    chunks = {}
    while True:
        hdr = f.read(8)
        if len(hdr) < 8:
            break
        cid, csize = struct.unpack("<4sI", hdr)
        chunks[cid] = (f.tell(), csize)
        f.seek(csize + (csize & 1), 1)
    return chunks


def read(path: str, start: int = 0, stop: Optional[int] = None,
         dtype: str = "float32") -> Tuple[np.ndarray, int]:
    """-> (samples[, channels], sample_rate); PCM16 and IEEE float32."""
    with open(path, "rb") as f:
        chunks = _find_chunks(f)
        if b"fmt " not in chunks or b"data" not in chunks:
            raise ValueError(f"{path}: missing fmt/data chunks")
        off, size = chunks[b"fmt "]
        f.seek(off)
        fmt_tag, n_chan, sr, _brate, block_align, bits = struct.unpack(
            "<HHIIHH", f.read(16)
        )
        if fmt_tag == 0xFFFE:  # WAVE_FORMAT_EXTENSIBLE: real tag in subformat
            f.seek(off + 24)
            fmt_tag = struct.unpack("<H", f.read(2))[0]
        doff, dsize = chunks[b"data"]
        bytes_per_frame = block_align or (n_chan * bits // 8)
        n_frames = dsize // bytes_per_frame
        if stop is None or stop > n_frames:
            stop = n_frames
        start = min(start, stop)
        count = stop - start
        f.seek(doff + start * bytes_per_frame)
        raw = f.read(count * bytes_per_frame)

    if fmt_tag == 1 and bits == 16:
        data = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif fmt_tag == 1 and bits == 32:
        data = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    elif fmt_tag == 3 and bits == 32:
        data = np.frombuffer(raw, np.float32).copy()
    elif fmt_tag == 1 and bits == 8:
        data = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"{path}: unsupported wav format tag={fmt_tag} bits={bits}")
    if n_chan > 1:
        data = data.reshape(-1, n_chan)
    if dtype != "float32":
        data = data.astype(dtype)
    return data, sr


def info(path: str) -> Tuple[int, int, int]:
    """-> (n_frames, sample_rate, channels) without reading samples."""
    with open(path, "rb") as f:
        chunks = _find_chunks(f)
        off, _ = chunks[b"fmt "]
        f.seek(off)
        _tag, n_chan, sr, _br, block_align, bits = struct.unpack("<HHIIHH", f.read(16))
        _doff, dsize = chunks[b"data"]
        bpf = block_align or (n_chan * bits // 8)
        return dsize // bpf, sr, n_chan


def write(path: str, data: np.ndarray, sample_rate: int):
    """Write float32 PCM16 wav (matching the reference's example dumps)."""
    data = np.asarray(data)
    if data.ndim == 1:
        data = data[:, None]
    pcm = np.clip(data * 32768.0, -32768, 32767).astype("<i2")
    n_chan = pcm.shape[1]
    payload = pcm.tobytes()
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(payload)) + b"WAVE")
        f.write(b"fmt " + struct.pack("<IHHIIHH", 16, 1, n_chan, sample_rate,
                                      sample_rate * n_chan * 2, n_chan * 2, 16))
        f.write(b"data" + struct.pack("<I", len(payload)) + payload)
