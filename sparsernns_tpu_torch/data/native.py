"""ctypes bindings of the native WAV decoder (counterpart of
``sparsernns_tpu/data/native.py``).

The decoder is the port's own copy, ``data/csrc/ndns_wavio.cpp``: a C++
thread pool that decodes PCM WAV files into float32 batch buffers. It is
a host reader, not a device kernel. At first use ``g++`` builds it into
``ops/cuda/_build/libndnswavio-<hash>.so`` (listed in ``.gitignore``;
the hash covers the source). Where no compiler is found or the build
fails, :func:`available` is False and the loader reads with the ``wave``
module instead, as the JAX package does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import List, Optional, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "csrc", "ndns_wavio.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "ops", "cuda", "_build")
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def lib_path() -> str:
    """Where the built library lives: named by the source's hash."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libndnswavio-{digest}.so")


def _build(out: str) -> bool:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        return False
    os.makedirs(BUILD_DIR, exist_ok=True)
    # build to a private name, then rename: concurrent builds never
    # load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE], check=True,
                       capture_output=True, timeout=300)
        os.replace(tmp, out)
        return True
    except (subprocess.SubprocessError, OSError):
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = lib_path()
        if not os.path.exists(path) and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        lib.ndns_decode_wav.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int]
        lib.ndns_decode_wav.restype = ctypes.c_int
        lib.ndns_decode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int)]
        lib.ndns_decode_batch.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the native decoder is built (or builds now) and loads."""
    return _load() is not None


def decode_wav(path: str, clip_len: int) -> Tuple[np.ndarray, int]:
    """One PCM WAV as float32[clip_len] (zero-padded or trimmed), and the
    decoder's return code (the samples read)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native wavio unavailable")
    out = np.empty(clip_len, np.float32)
    rc = lib.ndns_decode_wav(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        clip_len)
    if rc < 0:
        raise IOError(f"native decode failed ({rc}) for {path}")
    return out, rc


def decode_batch(paths: List[str], clip_len: int,
                 n_threads: int = 0) -> np.ndarray:
    """A batch of WAVs decoded concurrently -> float32 (n, clip_len)
    (``n_threads`` 0: the decoder's own choice)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native wavio unavailable")
    n = len(paths)
    out = np.empty((n, clip_len), np.float32)
    results = np.zeros(n, np.int32)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    failures = lib.ndns_decode_batch(
        c_paths, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        clip_len, n_threads,
        results.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    if failures:
        bad = [paths[i] for i in range(n) if results[i] < 0]
        raise IOError(f"native decode failed for {len(bad)} files: "
                      f"{bad[:3]}")
    return out
