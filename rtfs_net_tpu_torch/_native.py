"""Loader for the ``rtfs_net_tpu_native`` C++ extension (PESQ + crc32c)
(``rtfs_net_tpu/_native.py:load_native``, copied).

The extension is a top-level module built from the repo's ``native/``
sources (``native/setup.py``, ``module.cpp``, ``pesq_core.cpp``). A fresh
checkout has no build, so this module builds it on demand with the host's
C++ compiler into ``native/build/lib`` (git-ignored; the JAX package's
loader builds into the same place under the same file lock, so either
package may build it first), and memoizes a failure so a host without a
toolchain pays the attempt once.
"""
from __future__ import annotations

import importlib
import os
import subprocess
import sys
import threading

_MOD = "rtfs_net_tpu_native"
_cached = None
_attempted = False
# Serializes the on-demand build across THREADS (the eval engine scores from
# a thread pool; without this, threads arriving mid-build would see
# _attempted=True and memoize a spurious failure). Cross-process safety comes
# from the flock in _build.
_lock = threading.Lock()


def _native_dir() -> str | None:
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    d = os.path.join(root, "native")
    return d if os.path.isfile(os.path.join(d, "setup.py")) else None


def _build(native_dir: str) -> str | None:
    """Compile the extension into native/build/lib; returns the lib dir."""
    libdir = os.path.join(native_dir, "build", "lib")
    os.makedirs(libdir, exist_ok=True)
    lock_path = os.path.join(libdir, ".build.lock")
    lock = open(lock_path, "w")
    try:
        try:
            import fcntl

            fcntl.flock(lock, fcntl.LOCK_EX)  # serialize concurrent builders
        except Exception:
            pass
        # another process may have finished the build while we waited
        if not any(f.startswith(_MOD) and f.endswith(".so")
                   for f in os.listdir(libdir)):
            proc = subprocess.run(
                [sys.executable, "setup.py", "build_ext", "--build-lib", libdir],
                cwd=native_dir, capture_output=True, text=True, timeout=600,
            )
            if proc.returncode != 0:
                sys.stderr.write(
                    f"[rtfs_net_tpu_torch] native build failed:\n{proc.stderr[-2000:]}\n")
                return None
        return libdir
    except Exception as e:  # no toolchain, read-only tree, timeout, ...
        sys.stderr.write(f"[rtfs_net_tpu_torch] native build unavailable: {e!r}\n")
        return None
    finally:
        lock.close()


def load_native():
    """Import ``rtfs_net_tpu_native``, building it first if necessary.

    Returns the module, or None when neither a prebuilt .so nor a working
    toolchain is available (callers fall back — e.g. PESQ -> NaN with a
    warning, crc32c -> pure-python table).
    """
    global _cached, _attempted
    with _lock:
        if _cached is not None or _attempted:
            return _cached
        _attempted = True
        try:
            _cached = importlib.import_module(_MOD)
            return _cached
        except ImportError:
            pass
        native_dir = _native_dir()
        if native_dir is None:
            return None
        libdir = _build(native_dir)
        if libdir is None:
            return None
        if libdir not in sys.path:
            sys.path.insert(0, libdir)
        try:
            _cached = importlib.import_module(_MOD)
        except ImportError as e:
            sys.stderr.write(
                f"[rtfs_net_tpu_torch] built native module failed to import: {e}\n")
            _cached = None
        return _cached
