"""The port's own bindings of the native libraries: the token loader
(``native/dataloader.cpp``) and the group-allocation core
(``native/grpalloc.cpp``).

Each source is compiled on its own at first use, with the flags of
``native/Makefile``:

    g++ -O2 -std=c++17 -fPIC -shared -pthread -o libdataloader.so \
        native/dataloader.cpp
    g++ -O2 -std=c++17 -fPIC -shared -pthread -o libgrpalloc.so \
        native/grpalloc.cpp

into ``build/kubegpu_tpu_torch/<hash>/`` at the root of the checkout,
keyed by a hash of the source, the flags and the compiler (as
``kernels/_build.py`` keys the CUDA kernels), and loaded with ctypes. The loader's C API
(``dataloader.cpp:163-245``): ``dl_open``, ``dl_next``, ``dl_close``,
``dl_last_error``. The allocator's (``grpalloc.cpp:463-533``):
``grp_allocate`` and ``grp_last_error``, whose message is thread-local, so
concurrent searches are safe; ctypes drops the GIL for each call. A
missing compiler or a failed build raises with the compiler's output, and
neither library has a fallback.
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
GRPALLOC_SOURCE = ROOT / "native" / "grpalloc.cpp"
BUILD_ROOT = ROOT / "build" / "kubegpu_tpu_torch"
CXX_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-shared", "-pthread"]

_lock = threading.Lock()
_lib = None
_grp_lib = None


def _compiler() -> tuple:
    """The g++ on PATH and the first line of its ``--version``; ``(None,
    "")`` when there is none. The g++ on PATH, not $CXX: the library is
    loaded into a process that already holds the system's libstdc++
    (numpy and torch link it), so it must link that one. A $CXX of another
    toolchain (on the card's machine, one whose output carries a static
    libstdc++) builds a library whose first search crashes once numpy is
    imported."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if not cxx:
        return None, ""
    ver = subprocess.run([cxx, "--version"], capture_output=True, text=True)
    return cxx, (ver.stdout + ver.stderr).partition("\n")[0]


def _hashed_path(source: Path, name: str) -> Path:
    """Keyed by the source, the flags and the compiler (its path and
    version), so that a library another toolchain built is never reused."""
    cxx, version = _compiler()
    h = hashlib.sha256(source.read_bytes())
    h.update("\n".join([" ".join(CXX_FLAGS), str(cxx), version]).encode())
    return BUILD_ROOT / h.hexdigest()[:16] / name


def _library_path() -> Path:
    return _hashed_path(SOURCE, "libdataloader.so")


def _build(lib: Path, source: Path, what: str) -> None:
    cxx, _ = _compiler()
    if not cxx:
        raise RuntimeError(f"no C++ compiler (g++) found: the {what} "
                           "cannot be built")
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    if proc.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"{what} build failed ({cxx} exit "
            f"{proc.returncode}):\n{(proc.stdout + proc.stderr)[-4000:]}")
    os.replace(tmp, lib)        # atomic: concurrent builds race safely


def _open(path: Path, source: Path, what: str) -> ctypes.CDLL:
    if not path.exists():
        _build(path, source, what)
    return ctypes.CDLL(str(path))


def load() -> ctypes.CDLL:
    """The loader library, built on the first call, with the argument and
    result types of its C API declared."""
    global _lib
    with _lock:
        if _lib is None:
            lib = _open(_library_path(), SOURCE, "native token loader")
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


def load_grpalloc() -> ctypes.CDLL:
    """The allocator core, built on the first call. The engine calls this
    when its device scheduler is built (``GPUScheduler()``), so a search
    finds the library loaded and takes no lock."""
    global _grp_lib
    with _lock:
        if _grp_lib is None:
            lib = _open(_hashed_path(GRPALLOC_SOURCE, "libgrpalloc.so"),
                        GRPALLOC_SOURCE, "native allocator core")
            lib.grp_allocate.restype = ctypes.c_int
            lib.grp_allocate.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                         ctypes.c_int]
            lib.grp_last_error.restype = ctypes.c_char_p
            lib.grp_last_error.argtypes = []
            _grp_lib = lib
        return _grp_lib


def grp_allocate(payload: str) -> str:
    """One group-allocation search of the native core: ``payload`` and the
    reply are the line protocol of ``native/grpalloc.cpp``. The buffer
    starts at ``max(64 KiB, 4 * len + 4096)`` and grows 16x once when the
    core answers -2 (reply too large); any other negative answer raises
    with the core's message."""
    lib = _grp_lib or load_grpalloc()
    data = payload.encode()
    cap = max(1 << 16, 4 * len(data) + 4096)
    buf = ctypes.create_string_buffer(cap)
    n = lib.grp_allocate(data, buf, cap)
    if n == -2:
        cap *= 16
        buf = ctypes.create_string_buffer(cap)
        n = lib.grp_allocate(data, buf, cap)
    if n < 0:
        raise RuntimeError(
            f"grp_allocate failed: {lib.grp_last_error().decode()}")
    return buf.value.decode()
