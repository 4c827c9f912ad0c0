"""PESQ (ITU-T P.862) dispatcher (``rtfs_net_tpu/metrics/pesq.py``, copied).

Resolution order: (1) the native C extension built from ``native/pesq``
(this repo's C++ implementation of the narrowband P.862 pipeline),
(2) an installed ``pypesq``/``pesq`` package, (3) NaN with a one-time
warning — eval still runs, the PESQ column is just empty (the reference
hard-depends on the pypesq C extension, ``allwrapper.py:12,55``).
"""
from __future__ import annotations

import os
import warnings

import numpy as np

_impl = None
_warned = False


def _resolve():
    global _impl
    if _impl is not None:
        return _impl
    # RTFS_PESQ_BACKEND pins the dispatch: "native"/"pypesq"/"pesq" skip
    # the earlier fallbacks, "none" disables PESQ outright (the column
    # reads NaN), so a run that scores throwaway noise need not compile
    # the native extension.
    pin = os.environ.get("RTFS_PESQ_BACKEND", "").strip().lower()
    if pin == "none":
        _impl = ("none", None)
        return _impl
    try:
        if pin not in ("", "native"):
            raise ImportError(f"backend pinned to {pin!r}")
        from .._native import load_native

        nat = load_native()  # builds from native/ on demand if needed
        if nat is not None:
            _impl = ("native", nat.pesq)
            return _impl
    except Exception:
        pass
    try:
        if pin not in ("", "pypesq"):
            raise ImportError(f"backend pinned to {pin!r}")
        from pypesq import pesq as pypesq_fn

        _impl = ("pypesq", lambda ref, deg, fs: pypesq_fn(ref, deg, fs))
        return _impl
    except Exception:
        pass
    try:
        if pin not in ("", "pesq"):
            raise ImportError(f"backend pinned to {pin!r}")
        from pesq import pesq as pesq_fn

        _impl = ("pesq", lambda ref, deg, fs: pesq_fn(fs, ref, deg, "nb"))
        return _impl
    except Exception:
        pass
    _impl = ("none", None)
    return _impl


def pesq_backend() -> str:
    """The backend ``pesq`` scores with: "native", "pypesq", "pesq" or
    "none" (NaN)."""
    return _resolve()[0]


def pesq(est: np.ndarray, clean: np.ndarray, fs: int) -> float:
    """Argument order follows the reference call site exactly
    (``allwrapper.py:55`` passes (estimate, clean, fs) into pypesq's
    (ref, deg, fs) slot — replicated for metric parity)."""
    global _warned
    kind, fn = _resolve()
    if fn is None:
        if not _warned:
            warnings.warn("no PESQ implementation available; returning NaN")
            _warned = True
        return float("nan")
    if kind == "pesq":
        return float(fn(np.asarray(est), np.asarray(clean), fs))
    return float(fn(np.asarray(est, np.float32), np.asarray(clean, np.float32), fs))
