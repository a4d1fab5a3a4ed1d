"""Dynamic twin of the resource-lifecycle rule: per-test leak guard.

The port's copy of ``kubegpu_tpu/analysis/leakguard.py``, matching the
port's package exactly. The static rule proves package code *releases
what it acquires* along every path it can see; this module catches what
slips past it at runtime — a test that returns while a package-created
non-daemon thread is still running, or with package-created sockets
still open — attributed to the exact test that leaked, the way the
lockgraph plugin attributes lock-order inversions.

``threading.Thread.start`` and ``socket.socket`` construction are
wrapped, and the creation is recorded only when a frame whose file lies
inside the ``kubegpu_tpu_torch`` directory (the directory and a path
separator, so the JAX package's ``kubegpu_tpu/``, whose name is a prefix
of this one's, never matches) and outside this analysis package is on
the stack — pytest's own threads, stdlib servers accepting on their own
behalf, the JAX package and third-party machinery stay invisible.

The plugin (:mod:`kubegpu_tpu_torch.analysis.pytest_plugin`) snapshots
the live set at test start and judges the delta at teardown, after a
short grace so threads mid-exit don't flake. ``KGTPU_LEAKGUARD=0``
disables, like ``KGTPU_LOCKGRAPH=0``.
"""

from __future__ import annotations

import os
import socket
import sys
import threading
import time
import weakref
from typing import Any, List, Optional, Set, Tuple

_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ANALYSIS_DIR = os.path.join(_PACKAGE_DIR, "analysis")
_MAX_FRAMES = 12

_installed = False
_orig_thread_start: Optional[Any] = None
_orig_socket_init: Optional[Any] = None

# live tracking: threads keyed weakly, sockets in a WeakSet twin dict
_tracked_threads: "weakref.WeakSet[threading.Thread]" = weakref.WeakSet()
_thread_origin: "weakref.WeakKeyDictionary[threading.Thread, str]" = \
    weakref.WeakKeyDictionary()
_tracked_sockets: "weakref.WeakSet[socket.socket]" = weakref.WeakSet()
_socket_origin: "weakref.WeakKeyDictionary[socket.socket, str]" = \
    weakref.WeakKeyDictionary()


def in_package(path: str) -> bool:
    """True for a source file inside the package directory and outside
    its analysis package: the directory plus a separator, so a sibling
    directory whose name merely starts with the package's never
    matches."""
    path = os.path.abspath(path)
    return path.startswith(_PACKAGE_DIR + os.sep) and \
        not path.startswith(_ANALYSIS_DIR + os.sep)


def _package_frame(depth: int = 2) -> Optional[str]:
    """``"file:line"`` of the nearest package frame on the stack (the
    analysis package itself excluded), or None when the call did not
    originate from package code."""
    frame = sys._getframe(depth)
    for _ in range(_MAX_FRAMES):
        if frame is None:
            return None
        path = frame.f_code.co_filename
        if in_package(path):
            return f"{os.path.relpath(os.path.abspath(path), _PACKAGE_DIR)}:" \
                   f"{frame.f_lineno}"
        frame = frame.f_back
    return None


def _pool_managed(depth: int = 2) -> bool:
    """True when the thread is being spawned by ``concurrent.futures``
    machinery (a lazily-grown executor worker): pool workers are
    joined by the interpreter's atexit hook — join-or-daemon by
    construction — and an idle worker of a live executor is ownership,
    not a leak."""
    frame = sys._getframe(depth)
    for _ in range(_MAX_FRAMES):
        if frame is None:
            return False
        path = frame.f_code.co_filename.replace(os.sep, "/")
        if path.endswith("concurrent/futures/thread.py"):
            return True
        frame = frame.f_back
    return False


def install() -> None:
    """Wrap ``Thread.start`` and ``socket.socket.__init__`` (idempotent)."""
    global _installed, _orig_thread_start, _orig_socket_init
    if _installed:
        return
    _orig_thread_start = threading.Thread.start
    _orig_socket_init = socket.socket.__init__

    def start(self: threading.Thread, *args: Any, **kwargs: Any) -> Any:
        origin = _package_frame()
        if origin is not None and not _pool_managed():
            _tracked_threads.add(self)
            _thread_origin[self] = origin
        return _orig_thread_start(self, *args, **kwargs)

    def sock_init(self: socket.socket, *args: Any, **kwargs: Any) -> Any:
        out = _orig_socket_init(self, *args, **kwargs)
        origin = _package_frame()
        if origin is not None:
            _tracked_sockets.add(self)
            _socket_origin[self] = origin
        return out

    threading.Thread.start = start  # type: ignore[method-assign]
    socket.socket.__init__ = sock_init  # type: ignore[method-assign]
    _installed = True


def uninstall() -> None:
    global _installed
    if not _installed:
        return
    threading.Thread.start = _orig_thread_start  # type: ignore[method-assign]
    socket.socket.__init__ = _orig_socket_init  # type: ignore[method-assign]
    _installed = False


def installed() -> bool:
    return _installed


# ---- snapshots and the teardown verdict -------------------------------------


def snapshot() -> Tuple[Set[int], Set[int]]:
    """``(thread ids alive, open socket ids)`` among tracked objects —
    what existed before the test and is therefore not its leak."""
    threads = {id(t) for t in list(_tracked_threads) if t.is_alive()}
    socks = {id(s) for s in list(_tracked_sockets)
             if _is_open(s)}
    return threads, socks


def _is_open(sock: socket.socket) -> bool:
    try:
        return sock.fileno() != -1
    except (OSError, ValueError):
        return False


def leaked_threads(before: Set[int],
                   grace_s: float = 2.0) -> List[Tuple[str, str]]:
    """Non-daemon package-created threads still alive that did not
    exist at ``before``-time, after up to ``grace_s`` of joining —
    ``(thread name, creation origin)`` pairs."""
    deadline = time.monotonic() + grace_s
    out: List[Tuple[str, str]] = []
    for thread in list(_tracked_threads):
        if id(thread) in before or thread.daemon or \
                thread is threading.current_thread():
            continue
        if thread.is_alive():
            thread.join(timeout=max(0.0, deadline - time.monotonic()))
        if thread.is_alive():
            out.append((thread.name,
                        _thread_origin.get(thread, "<unknown>")))
    return out


def leaked_sockets(before: Set[int],
                   grace_s: float = 0.2) -> List[str]:
    """Package-created sockets still open that did not exist at
    ``before``-time (short grace: a socket whose last reference just
    dropped closes on the spot under refcounting)."""
    deadline = time.monotonic() + grace_s
    while True:
        out = [
            f"{_socket_origin.get(s, '<unknown>')} (fd {s.fileno()})"
            for s in list(_tracked_sockets)
            if id(s) not in before and _is_open(s)
        ]
        if not out or time.monotonic() >= deadline:
            return out
        time.sleep(0.05)
