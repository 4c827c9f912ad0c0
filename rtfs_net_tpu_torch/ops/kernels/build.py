"""Build a kernel source of ``csrc/`` with ``nvcc`` into a shared library
with a plain C interface, and load it with ``ctypes``.

The library is built at first use into ``csrc/build/``, named by a hash
of the source and the flags, so an edited source is rebuilt and an
unchanged one is loaded as is.
Concurrent builds each write a private file and rename it into place.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: dict = {}


def nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    for cand in (shutil.which("nvcc"), CUDA_HOME and os.path.join(CUDA_HOME, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(source: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{source.stem}-{digest.hexdigest()[:16]}.so"


def build(source: Path) -> Path:
    """Compile ``source`` unless its library exists; return the library."""
    lib = library_path(source)
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {source.name}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def load(source_name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<source_name>``, once per process."""
    with _lock:
        lib = _libs.get(source_name)
        if lib is None:
            lib = ctypes.CDLL(str(build(CSRC / source_name)))
            _libs[source_name] = lib
        return lib
