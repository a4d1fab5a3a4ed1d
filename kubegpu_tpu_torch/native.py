"""The port's own binding of the native token loader
(``native/dataloader.cpp``).

The source is compiled on its own at first use, with the flags of
``native/Makefile``:

    g++ -O2 -std=c++17 -fPIC -shared -pthread -o libdataloader.so \
        native/dataloader.cpp

into ``build/kubegpu_tpu_torch/<hash>/`` at the root of the checkout,
keyed by a hash of the source and the flags (as ``kernels/_build.py``
keys the CUDA kernels), and loaded with ctypes. Its C API
(``dataloader.cpp:163-245``): ``dl_open``, ``dl_next``, ``dl_close``,
``dl_last_error``. A failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "native" / "dataloader.cpp"
BUILD_ROOT = ROOT / "build" / "kubegpu_tpu_torch"
CXX_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-shared", "-pthread"]

_lock = threading.Lock()
_lib = None


def _library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16] / "libdataloader.so"


def _build(lib: Path) -> None:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise RuntimeError("no C++ compiler (g++) found: the native token "
                           "loader cannot be built")
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"native token loader build failed ({cxx} exit "
            f"{proc.returncode}):\n{(proc.stdout + proc.stderr)[-4000:]}")
    os.replace(tmp, lib)        # atomic: concurrent builds race safely


def load() -> ctypes.CDLL:
    """The loader library, built on the first call, with the argument and
    result types of its C API declared."""
    global _lib
    with _lock:
        if _lib is None:
            path = _library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            lib.dl_open.restype = ctypes.c_void_p
            lib.dl_open.argtypes = [ctypes.c_char_p, ctypes.c_longlong,
                                    ctypes.c_longlong, ctypes.c_ulonglong,
                                    ctypes.c_int]
            lib.dl_next.restype = ctypes.c_longlong
            lib.dl_next.argtypes = [ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_int32),
                                    ctypes.c_longlong]
            lib.dl_close.restype = None
            lib.dl_close.argtypes = [ctypes.c_void_p]
            lib.dl_last_error.restype = ctypes.c_char_p
            lib.dl_last_error.argtypes = []
            _lib = lib
        return _lib
