"""Build the hand-written CUDA kernels and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and no PyTorch headers
(it may include headers of ``csrc/``), so ``nvcc`` builds it in seconds::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
        -Xcompiler -fPIC -o _build/lib<name>-<hash>.so csrc/<name>.cu

The library name carries a hash of the source and of every ``csrc/``
header it includes, so an edited source or header is rebuilt and an
unchanged one is reused from ``_build/`` (listed in ``.gitignore``).
:func:`build_all` starts one ``nvcc`` per source, all at once. A missing
``nvcc`` or a failed build raises; nothing falls back. :func:`entry` is
how a wrapper reaches a C function: its library built and loaded at first
use, its argument and result types set once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from typing import Any, Dict, Iterable, List, Sequence, Tuple

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
SOURCES = ("diag_scan", "fused_s5", "layer_tail", "layer_tail_bwd",
           "engine_layer", "engine_network", "block_sparse", "qat_scan",
           "fxp_scan")
_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_entries: Dict[Tuple[str, str], Any] = {}
#: ``nvcc -Xptxas -v`` output of each build made in this process
#: (registers, shared memory and spills per kernel)
build_logs: Dict[str, str] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _hash_with_includes(fname: str, digest, seen: set) -> None:
    """Feed ``csrc/<fname>`` and, recursively, the ``csrc/`` headers it
    includes with quotes into ``digest``."""
    if fname in seen:
        return
    seen.add(fname)
    with open(os.path.join(CSRC, fname), "rb") as f:
        text = f.read()
    digest.update(fname.encode() + b"\0" + text)
    for inc in _INCLUDE.findall(text):
        _hash_with_includes(inc.decode(), digest, seen)


def _lib_path(name: str) -> str:
    digest = hashlib.sha256()
    _hash_with_includes(f"{name}.cu", digest, set())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def _start(name: str, out: str) -> subprocess.Popen:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC, f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(name: str, out: str, proc: subprocess.Popen) -> None:
    log, _ = proc.communicate()
    build_logs[name] = log
    tmp = f"{out}.{os.getpid()}.tmp"
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)


def build_all(names: Iterable[str] = SOURCES) -> List[str]:
    """Build every listed kernel that has no current library, one
    ``nvcc`` per source started together. Returns the library paths."""
    paths = {n: _lib_path(n) for n in names}
    procs = {n: _start(n, p) for n, p in paths.items()
             if not os.path.exists(p)}
    for n, proc in procs.items():
        _finish(n, paths[n], proc)
    return list(paths.values())


def entry(name: str, symbol: str, argtypes: Sequence,
          restype: Any = ctypes.c_int):
    """The C function ``symbol`` of kernel ``name``'s library (built and
    loaded at first use) with its argument and result types, set once."""
    fn = _entries.get((name, symbol))
    if fn is None:
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                path, = build_all([name])
                lib = _libs[name] = ctypes.CDLL(path)
        fn = getattr(lib, symbol)
        fn.argtypes = list(argtypes)
        fn.restype = restype
        _entries[(name, symbol)] = fn
    return fn


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launcher."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
