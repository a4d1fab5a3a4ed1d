"""Pytest plugin: a session under the port's dynamic analysis harnesses.

The port's copy of ``kubegpu_tpu/analysis/pytest_plugin.py``, for a
session that runs without the JAX package's plugin (which
``tests/conftest.py`` loads)::

    python -m pytest --noconftest -p kubegpu_tpu_torch.analysis.pytest_plugin tests/...

Three layers, each over ``kubegpu_tpu_torch`` only:

* **lock-order harness** — every lock the package constructs is
  instrumented (:mod:`kubegpu_tpu_torch.analysis.lockgraph`); at session
  end the accumulated acquisition graph is checked for cycles and the
  run FAILS if any exist — a lock-order inversion is a deadlock waiting
  for the right interleaving. Disable with ``KGTPU_LOCKGRAPH=0``.

* **per-test leak guard** — the dynamic twin of the static
  resource-lifecycle rule (:mod:`kubegpu_tpu_torch.analysis.leakguard`):
  package-created threads and sockets are snapshotted at test start,
  and a test that finishes leaving a non-daemon package thread alive or
  a package socket open FAILS at teardown, with the creation site in
  the message. Disable with ``KGTPU_LEAKGUARD=0``.

* **dispatch counter** (opt-in, ``KGTPU_DISPATCHCOUNT=1``) — installs
  :mod:`kubegpu_tpu_torch.analysis.dispatchcount` (the counting
  ``TorchDispatchMode`` and the wrapped sync methods) for the whole
  session and prints its totals at the end. OFF by default: it puts a
  dispatch mode under every operator the session runs.
"""

from __future__ import annotations

import os
from typing import Iterator

import pytest

from kubegpu_tpu_torch.analysis import dispatchcount, leakguard, lockgraph

_ENV_FLAG = "KGTPU_LOCKGRAPH"
_LEAK_FLAG = "KGTPU_LEAKGUARD"
_DISPATCH_FLAG = "KGTPU_DISPATCHCOUNT"


def _enabled() -> bool:
    return os.environ.get(_ENV_FLAG, "1") not in ("0", "false", "no")


def _leak_enabled() -> bool:
    return os.environ.get(_LEAK_FLAG, "1") not in ("0", "false", "no")


def _dispatch_enabled() -> bool:
    # opt-in, unlike the other two: a dispatch mode under every operator
    # must never be on by default
    return os.environ.get(_DISPATCH_FLAG, "0") in ("1", "true", "yes")


def pytest_configure(config: object) -> None:
    if _enabled():
        lockgraph.install()
    if _leak_enabled():
        leakguard.install()
    if _dispatch_enabled():
        try:
            dispatchcount.install()
        except ImportError:
            # no torch in this environment: the counter has nothing to
            # count, and the flag is best-effort by design
            pass


def pytest_unconfigure(config: object) -> None:
    lockgraph.uninstall()
    leakguard.uninstall()
    if dispatchcount.installed():
        dispatchcount.uninstall()


@pytest.fixture(autouse=True)
def _kgtpu_torch_leakguard(request: object) -> Iterator[None]:
    """Per-test snapshot/verdict. Autouse and dependency-free, so it is
    set up before (and torn down after) the test's own fixtures — a
    server a fixture shuts down in ITS teardown is already closed by
    the time the verdict runs."""
    if not leakguard.installed():
        yield
        return
    threads_before, socks_before = leakguard.snapshot()
    yield
    threads = leakguard.leaked_threads(threads_before)
    if threads:
        names = ", ".join(f"{name} (started at {origin})"
                          for name, origin in threads)
        pytest.fail(
            f"leak guard: non-daemon package thread(s) still alive at "
            f"teardown: {names} — join them, make them daemon, or "
            f"disable with {_LEAK_FLAG}=0", pytrace=False)
    socks = leakguard.leaked_sockets(socks_before)
    if socks:
        pytest.fail(
            f"leak guard: package-created socket(s) still open at "
            f"teardown: {', '.join(socks)} — close the client/server "
            f"that owns them, or disable with {_LEAK_FLAG}=0",
            pytrace=False)


def pytest_terminal_summary(terminalreporter: object, exitstatus: int,
                            config: object) -> None:
    if dispatchcount.installed():
        snap = dispatchcount.counts()
        totals = {kind: sum(c[kind] for c in snap["sections"].values())
                  for kind in ("dispatches", "syncs")}
        terminalreporter.write_line(
            f"dispatchcount: {totals['dispatches']} dispatch(es), "
            f"{totals['syncs']} sync(s) in {len(snap['sections'])} "
            f"section(s), {snap['builds_total']} kernel build(s) across "
            f"the session")
    if not lockgraph.installed():
        return
    edges = len(lockgraph.GLOBAL_GRAPH.edges)
    cycles = lockgraph.GLOBAL_GRAPH.cycles()
    if cycles:
        terminalreporter.section("lock-order inversions", sep="=")
        terminalreporter.write_line(lockgraph.GLOBAL_GRAPH.render_cycles())
    else:
        terminalreporter.write_line(
            f"lockgraph: {edges} ordering edge(s) observed, no inversions")


def pytest_sessionfinish(session: object, exitstatus: int) -> None:
    if not lockgraph.installed():
        return
    if lockgraph.GLOBAL_GRAPH.cycles():
        # mutating session.exitstatus is the supported way to flip the
        # final exit code from a sessionfinish hook
        session.exitstatus = 1
