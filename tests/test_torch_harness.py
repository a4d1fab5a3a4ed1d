"""The port's dynamic harnesses (``kubegpu_tpu_torch/analysis/lockgraph.py``,
``leakguard.py`` and ``pytest_plugin.py``): the lock-order graph held
against the JAX package's on one two-lock inversion, both harnesses'
package gates (``kubegpu_tpu_torch`` exactly: never the JAX package,
never a sibling sharing the prefix), the leak guard naming a leaked
thread's creation site, and the plugin in a pytest session of its own
(``--noconftest``, so the JAX package's plugin is not loaded), where a
leaking test fails at teardown, a clean one passes and an inversion fails
the session."""

import _thread
import os
import subprocess
import sys
import textwrap
import threading

import pytest

pytest.importorskip("torch")

from kubegpu_tpu.analysis import lockgraph as jax_lockgraph  # noqa: E402
from kubegpu_tpu_torch.analysis import leakguard, lockgraph  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "kubegpu_tpu_torch")
PLAIN_LOCK = type(_thread.allocate_lock())


def _inversion(module):
    """Two instrumented locks of ``module`` on a private graph, taken in
    both orders on one thread (no deadlock: the orders never overlap)."""
    graph = module.LockGraph()
    a = module.InstrumentedLock(_thread.allocate_lock(), "a.py:1", graph)
    b = module.InstrumentedLock(_thread.allocate_lock(), "b.py:2", graph)
    with a:
        with b:
            pass
    with b:
        with a:
            pass
    return graph


def test_lock_graph_reports_the_jax_cycle_on_one_inversion():
    port = _inversion(lockgraph)
    jax = _inversion(jax_lockgraph)
    assert port.cycles() == jax.cycles() == [["a.py:1", "b.py:2", "a.py:1"]]
    assert set(port.edges) == set(jax.edges)
    assert port.render_cycles().splitlines()[0] == \
        jax.render_cycles().splitlines()[0] == \
        "lock-order inversion: a.py:1 -> b.py:2 -> a.py:1"


def test_reentry_and_condition_waits_record_no_edge():
    graph = lockgraph.LockGraph()
    r = lockgraph.InstrumentedLock(_thread.RLock(), "r.py:1", graph)
    with r:
        with r:
            pass
    cond = threading.Condition(r)
    with cond:
        cond.wait(0.01)
    assert graph.edges == {} and graph.cycles() == []


def _made_by(module_name, factory):
    """``factory()`` called from a frame whose module is
    ``module_name`` — the frame the lock-order gate reads."""
    scope = {"__name__": module_name, "factory": factory}
    exec(compile("made = factory()", f"<{module_name}>", "exec"), scope)
    return scope["made"]


@pytest.mark.parametrize("module_name,wrapped", [
    ("kubegpu_tpu_torch", True),
    ("kubegpu_tpu_torch.scheduler.cache", True),
    ("kubegpu_tpu", False),
    ("kubegpu_tpu.scheduler.cache", False),
    ("kubegpu_tpu_torchx.cache", False),
    ("threading", False),
])
def test_lock_gate_matches_the_port_package_exactly(module_name, wrapped):
    for factory in (lockgraph._lock_factory, lockgraph._rlock_factory):
        made = _made_by(module_name, factory)
        assert isinstance(made, lockgraph.InstrumentedLock) == wrapped
        if wrapped:
            assert made._site == f"<{module_name}>:1"
        else:
            assert not isinstance(made, jax_lockgraph.InstrumentedLock)
    cond = _made_by(module_name, lockgraph._PatchingCondition)
    assert isinstance(cond._lock, lockgraph.InstrumentedLock) == wrapped


def test_lock_factories_do_not_wrap_a_jax_package_lock():
    """The JAX package's own objects get plain locks from the port's
    factories (its scheduling queue's condition and its cache's lock),
    whatever the JAX harness patched into ``threading``."""
    assert _made_by("kubegpu_tpu.scheduler.queue",
                    lockgraph._lock_factory).__class__ is PLAIN_LOCK
    assert lockgraph._real_condition is lockgraph._native_condition()
    assert lockgraph._real_condition.__module__ == "threading"
    assert lockgraph._real_lock_factory is _thread.allocate_lock


@pytest.mark.parametrize("relpath,inside", [
    ("kubegpu_tpu_torch/scheduler/core.py", True),
    ("kubegpu_tpu_torch/cluster/httpapi.py", True),
    ("kubegpu_tpu_torch/analysis/races.py", False),
    ("kubegpu_tpu/scheduler/core.py", False),
    ("kubegpu_tpu_torchx/core.py", False),
    ("tests/test_torch_harness.py", False),
])
def test_leak_gate_matches_the_port_directory_exactly(relpath, inside):
    assert leakguard.in_package(os.path.join(REPO, relpath)) == inside


def _run(code, timeout=60):
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=timeout)


def test_leak_guard_names_a_leaked_port_thread():
    """A non-daemon thread started from the port's code and left alive is
    a leak named by its creation site; a daemon one, a joined one and one
    the JAX package starts are not (a process of its own: no JAX plugin
    wraps the same methods)."""
    proc = _run('''
        import os, threading
        from kubegpu_tpu_torch.analysis import leakguard

        leakguard.install()
        stop = threading.Event()

        def start(path, daemon):
            scope = {"threading": threading, "stop": stop,
                     "daemon": daemon}
            exec(compile(
                "t = threading.Thread(target=stop.wait, daemon=daemon,"
                " name='probe')\\nt.start()", path, "exec"), scope)
            return scope["t"]

        pkg = os.path.abspath("kubegpu_tpu_torch")
        threads_before, _ = leakguard.snapshot()
        leaked = start(os.path.join(pkg, "scheduler", "probe.py"), False)
        daemon = start(os.path.join(pkg, "scheduler", "probe.py"), True)
        jax = start(os.path.abspath("kubegpu_tpu/scheduler/probe.py"),
                    False)
        found = leakguard.leaked_threads(threads_before, grace_s=0.2)
        print("FOUND", found)
        stop.set()
        for t in (leaked, daemon, jax):
            t.join()
        print("AFTER", leakguard.leaked_threads(threads_before, 0.2))
        leakguard.uninstall()
        assert threading.Thread.start.__module__ == "threading"
    ''')
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "FOUND [('probe', 'scheduler/probe.py:2')]" in proc.stdout
    assert "AFTER []" in proc.stdout


PLUGIN_TESTS = '''
import os
import threading

PKG = {pkg!r}


def _package_thread(seconds):
    scope = {{"threading": threading, "seconds": seconds}}
    exec(compile(
        "stop = threading.Event()\\n"
        "t = threading.Thread(target=stop.wait, args=(seconds,))\\n"
        "t.start()", os.path.join(PKG, "cluster", "probe.py"), "exec"),
        scope)
    return scope


def test_clean():
    scope = _package_thread(30)
    scope["stop"].set()
    scope["t"].join()


def test_leaks():
    _package_thread(4)
'''

INVERSION_TEST = '''
import threading


def test_inversion():
    scope = {"__name__": "kubegpu_tpu_torch.probe", "threading": threading}
    exec("a = threading.Lock()\\nb = threading.Lock()", scope)
    a, b = scope["a"], scope["b"]
    with a:
        with b:
            pass
    with b:
        with a:
            pass
'''


def _session(tmp_path, name, body):
    path = tmp_path / name
    path.write_text(body)
    env = dict(os.environ, KGTPU_LEAKGUARD="1", KGTPU_LOCKGRAPH="1")
    return subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-p",
         "kubegpu_tpu_torch.analysis.pytest_plugin", "-p",
         "no:cacheprovider", "-q", "-rA", str(path)],
        cwd=REPO, capture_output=True, text=True, timeout=120, env=env)


def test_plugin_fails_a_leaking_test_and_passes_a_clean_one(tmp_path):
    proc = _session(tmp_path, "test_leaky.py",
                    PLUGIN_TESTS.format(pkg=PKG))
    out = proc.stdout + proc.stderr
    assert proc.returncode == 1, out
    outcomes = {line.split()[0]: [] for line in out.splitlines()
                if line.startswith(("PASSED ", "ERROR "))}
    for line in out.splitlines():
        if line.startswith(("PASSED ", "ERROR ")):
            outcomes[line.split()[0]].append(line.rsplit("::", 1)[-1])
    assert outcomes["PASSED"] == ["test_clean", "test_leaks"]
    assert outcomes["ERROR"] == ["test_leaks"]
    assert "leak guard: non-daemon package thread(s) still alive" in out
    assert "cluster/probe.py:3" in out
    assert "1 error" in out  # test_leaks' call passes, its teardown fails
    assert "lockgraph:" in out and "no inversions" in out


def test_plugin_fails_the_session_on_a_lock_order_inversion(tmp_path):
    proc = _session(tmp_path, "test_inverted.py", INVERSION_TEST)
    out = proc.stdout + proc.stderr
    assert "1 passed" in out, out
    assert proc.returncode == 1, out
    assert "lock-order inversion:" in out
    assert "<string>:1 -> <string>:2 -> <string>:1" in out
