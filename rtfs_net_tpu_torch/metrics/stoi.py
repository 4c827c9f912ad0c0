"""STOI — Short-Time Objective Intelligibility (Taal et al., ICASSP 2010)
(``rtfs_net_tpu/metrics/stoi.py``, copied).

numpy implementation of the standard algorithm with the canonical
parameter set (10 kHz, 256-sample frames zero-padded to 512, 15
one-third-octave bands from 150 Hz, 384 ms segments, -15 dB clipping),
matching the ``pystoi`` package the reference evaluates with
(``allwrapper.py:13,58``). Extended variant included.
"""
from __future__ import annotations

import numpy as np
from scipy.signal import resample_poly

FS = 10000
N_FRAME = 256
NFFT = 512
NUMBAND = 15
MINFREQ = 150
N = 30
BETA = -15.0
DYN_RANGE = 40.0


def thirdoct(fs: int, nfft: int, num_bands: int, min_freq: float):
    f = np.linspace(0, fs, nfft + 1)[: nfft // 2 + 1]
    k = np.arange(num_bands, dtype=float)
    cf = (2.0 ** (1.0 / 3)) ** k * min_freq
    freq_low = min_freq * np.power(2.0, (2 * k - 1) / 6)
    freq_high = min_freq * np.power(2.0, (2 * k + 1) / 6)
    obm = np.zeros((num_bands, len(f)))
    for i in range(len(cf)):
        fl = int(np.argmin(np.square(f - freq_low[i])))
        fh = int(np.argmin(np.square(f - freq_high[i])))
        obm[i, fl:fh] = 1
    return obm, cf


_OBM, _CF = thirdoct(FS, NFFT, NUMBAND, MINFREQ)


def _frames(x: np.ndarray, frame_len: int, hop: int) -> np.ndarray:
    n = (len(x) - frame_len) // hop + 1
    if n <= 0:
        return np.zeros((0, frame_len), x.dtype)
    idx = np.arange(frame_len)[None, :] + hop * np.arange(n)[:, None]
    return x[idx]


def remove_silent_frames(x, y, dyn_range, frame_len, hop):
    w = np.hanning(frame_len + 2)[1:-1]
    xf = _frames(x, frame_len, hop) * w
    yf = _frames(y, frame_len, hop) * w
    energies = 20 * np.log10(np.linalg.norm(xf, axis=1) + 1e-15)
    mask = energies > (np.max(energies) - dyn_range)
    xf, yf = xf[mask], yf[mask]
    # overlap-add back
    n_out = (len(xf) - 1) * hop + frame_len if len(xf) else 0
    xs = np.zeros(n_out)
    ys = np.zeros(n_out)
    for i in range(len(xf)):
        xs[i * hop : i * hop + frame_len] += xf[i]
        ys[i * hop : i * hop + frame_len] += yf[i]
    return xs, ys


def _stft_bands(x: np.ndarray) -> np.ndarray:
    frames = _frames(x, N_FRAME, N_FRAME // 2)
    w = np.hanning(N_FRAME + 2)[1:-1]
    spec = np.fft.rfft(frames * w, NFFT, axis=1)  # (T, F)
    return np.sqrt(_OBM @ (np.abs(spec) ** 2).T)  # (bands, T)


def stoi(clean: np.ndarray, est: np.ndarray, fs_sig: int,
         extended: bool = False) -> float:
    if clean.shape != est.shape:
        raise ValueError("clean and est must have the same shape")
    x = np.asarray(clean, np.float64)
    y = np.asarray(est, np.float64)
    if fs_sig != FS:
        x = resample_poly(x, FS, fs_sig)
        y = resample_poly(y, FS, fs_sig)
    x, y = remove_silent_frames(x, y, DYN_RANGE, N_FRAME, N_FRAME // 2)
    if len(x) < N_FRAME:
        return 1e-5
    xb = _stft_bands(x)
    yb = _stft_bands(y)
    T = xb.shape[1]
    if T < N:
        return 1e-5

    if extended:
        total = 0.0
        count = 0
        def row_col_normalize(s):
            s = s - s.mean(axis=1, keepdims=True)
            s = s / (np.linalg.norm(s, axis=1, keepdims=True) + 1e-15)
            s = s - s.mean(axis=0, keepdims=True)
            s = s / (np.linalg.norm(s, axis=0, keepdims=True) + 1e-15)
            return s

        for m in range(N, T + 1):
            xs = row_col_normalize(xb[:, m - N : m])
            ys = row_col_normalize(yb[:, m - N : m])
            total += np.sum(xs * ys) / N
            count += 1
        return float(total / count)

    clip = 10 ** (-BETA / 20)
    total = 0.0
    count = 0
    for m in range(N, T + 1):
        xs = xb[:, m - N : m]
        ys = yb[:, m - N : m]
        alpha = np.linalg.norm(xs, axis=1, keepdims=True) / (
            np.linalg.norm(ys, axis=1, keepdims=True) + 1e-15
        )
        ys_n = np.minimum(ys * alpha, xs * (1 + clip))
        xm = xs - xs.mean(axis=1, keepdims=True)
        ym = ys_n - ys_n.mean(axis=1, keepdims=True)
        corr = np.sum(xm * ym, axis=1) / (
            np.linalg.norm(xm, axis=1) * np.linalg.norm(ym, axis=1) + 1e-15
        )
        total += corr.sum() / NUMBAND
        count += 1
    return float(total / count)
