"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/*.cu`` source compiles on its own, all sources at once (one
``nvcc`` process each), into a shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o <lib>.so <source>.cu

The output goes to ``build/kubegpu_tpu_torch/<hash>/`` at the root of the
checkout, keyed by a hash of every source and header, so an edited
kernel never loads a stale library. nvcc's output (``-Xptxas -v``: the
registers, shared memory and spills of each kernel) is kept beside each
library as ``<name>.log``. Nothing is downloaded and nothing outside
``csrc/`` is built.
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
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / \
    "kubegpu_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be "
                           "built (set CUDA_HOME or put nvcc on PATH)")
    return path


def _sources_hash() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return BUILD_ROOT / _sources_hash()


def build_all() -> dict:
    """Compile every ``csrc/*.cu`` that has no library yet, in parallel;
    return ``{name: Path(lib)}``. Raises with nvcc's output on failure."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    todo, libs = [], {}
    for src in sorted(CSRC.glob("*.cu")):
        lib = out / f"lib{src.stem}.so"
        libs[src.stem] = lib
        if not lib.exists():
            todo.append((src, lib))
    procs = []
    try:
        for src, lib in todo:
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                   str(src)]
            procs.append((subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, lib))
        errors = []
        for proc, tmp, lib in procs:
            log, _ = proc.communicate()
            lib.with_suffix(".log").write_text(log)
            if proc.returncode:
                errors.append(f"{lib.name}: nvcc exit {proc.returncode}\n"
                              f"{log[-4000:]}")
            else:
                os.replace(tmp, lib)
        if errors:
            raise RuntimeError("CUDA kernel build failed:\n"
                               + "\n".join(errors))
    finally:
        for proc, _, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return libs


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (building every
    source on the first call)."""
    with _lock:
        if name not in _libs:
            libs = build_all()
            if name not in libs:
                raise RuntimeError(f"no CUDA source csrc/{name}.cu")
            _libs[name] = ctypes.CDLL(str(libs[name]))
        return _libs[name]


def build_log(name: str) -> str:
    """nvcc's output for ``csrc/<name>.cu`` from the current build."""
    log = build_dir() / f"lib{name}.log"
    return log.read_text() if log.exists() else ""
