"""The port's native allocator core (`kubegpu_tpu_torch/native.py` over
``native/grpalloc.cpp``, dispatched from
`kubegpu_tpu_torch/allocator/grpalloc.py`).

On 120 seeded random problems in the GPU grammar (``chip_smoke.py``'s
`alloc_problem`, which its allocator leg runs on the card's host too:
gpugrp1 / gpugrp0 / gpu trees, memory, cards and enum attributes, usage
already on the node, running and init containers) the port's native
route equals its own
Python path (fit, score bit for bit, placements, the multiset of reasons)
and the JAX package's native route. Also: the re-check path with
``allocate_from`` already set, a running and an init container sharing a
name, the two inputs the line protocol cannot carry (each taken by the
Python path and counted in ``allocator_native_fallbacks_total``), the
faults that raise (a failed build, a native error, a reply out of step),
and the engine on a 4-host HGX cluster whose searches all go native."""

import copy
import random
import sys
import threading

import pytest

pytest.importorskip("torch")

from kubegpu_tpu import native as jnative  # noqa: E402
from kubegpu_tpu.allocator import grpalloc as jalloc  # noqa: E402
from kubegpu_tpu.core import types as jtypes  # noqa: E402
from kubegpu_tpu_torch import metrics, native  # noqa: E402
from kubegpu_tpu_torch.allocator import grpalloc as talloc  # noqa: E402
from kubegpu_tpu_torch.core import types as ttypes  # noqa: E402
from kubegpu_tpu_torch.node import fake  # noqa: E402
from kubegpu_tpu_torch.scheduler.gpu_scheduler import GPUScheduler  # noqa: E402
from tests.torch_sched import cluster, placement, pod  # noqa: E402

from chip_smoke import alloc_objects as _objects  # noqa: E402
from chip_smoke import alloc_problem  # noqa: E402

G = "alpha/grpresource"
N_PROBLEMS = 120


def _placements(pod_info) -> dict:
    return {(phase, name): dict(c.allocate_from)
            for phase in ("running_containers", "init_containers")
            for name, c in getattr(pod_info, phase).items()}


def _outcome(fit, types, problem):
    node, pod_info = _objects(types, problem)
    fits, reasons, score = fit(node, pod_info, True)
    return {"fits": fits, "score": score,
            "reasons": sorted(r.info() for r in reasons),
            "placed": _placements(pod_info)}


def _problems():
    rng = random.Random(11)
    return [alloc_problem(rng) for _ in range(N_PROBLEMS)]


@pytest.fixture
def counted(monkeypatch):
    """Every call of the port's native search, recorded."""
    calls = []
    real = native.grp_allocate

    def grp_allocate(payload):
        calls.append(payload)
        return real(payload)

    monkeypatch.setattr(native, "grp_allocate", grp_allocate)
    return calls


def test_native_route_equals_the_python_path_on_random_problems(counted):
    """Fit, score bit for bit, placements and the reason multiset."""
    before = metrics.NATIVE_FALLBACKS.value
    fitting = failing = 0
    for trial, problem in enumerate(_problems()):
        got = _outcome(talloc.pod_fits_group_constraints, ttypes, problem)
        want = _outcome(talloc._pod_fits_group_constraints_py, ttypes,
                        problem)
        assert got == want, f"trial {trial}: {problem}"
        fitting += got["fits"]
        failing += not got["fits"]
    assert len(counted) == N_PROBLEMS
    assert metrics.NATIVE_FALLBACKS.value == before
    assert fitting > 20 and failing > 20     # both outcomes exercised


def test_native_route_equals_the_jax_native_route():
    lib = jnative.get_lib()
    assert lib is not None and hasattr(lib, "grp_allocate")
    for trial, problem in enumerate(_problems()):
        got = _outcome(talloc.pod_fits_group_constraints, ttypes, problem)
        want = _outcome(jalloc._native_pod_fits, jtypes, problem)
        assert got == want, f"trial {trial}: {problem}"


def test_recheck_with_allocate_from_set(counted):
    """The idempotent re-check: placements already made are re-scored
    through the core, never re-placed, as the Python path does."""
    rechecked = 0
    for trial, problem in enumerate(_problems()[:40]):
        node, pod_info = _objects(ttypes, problem)
        fits, _, _ = talloc.pod_fits_group_constraints(node, pod_info, True)
        placed = _placements(pod_info)
        pod_py = copy.deepcopy(pod_info)
        got = talloc.pod_fits_group_constraints(node, pod_info, True)
        want = talloc._pod_fits_group_constraints_py(node, pod_py, True)
        assert (got[0], got[2], sorted(r.info() for r in got[1])) == \
            (want[0], want[2], sorted(r.info() for r in want[1])), trial
        assert _placements(pod_info) == placed == _placements(pod_py)
        rechecked += fits
    assert rechecked > 5
    # each re-check marks every container re-score: no search
    assert sum(" 0 1\n" in p and "\nF " in p for p in counted) >= rechecked


def test_running_and_init_container_share_a_name():
    """Placements are matched by position in the reply, not by name."""
    alloc = {f"{G}/gpu/dev{d}/{leaf}": n for d in range(4)
             for leaf, n in (("cards", 1), ("memory", 80000))}
    problem = {"alloc": alloc, "used": {}, "containers": [
                   ("c0", False, {f"{G}/gpu/r0/cards": 1}),
                   ("c0", True, {f"{G}/gpu/q0/cards": 1,
                                 f"{G}/gpu/q0/memory": 0})]}
    got = _outcome(talloc.pod_fits_group_constraints, ttypes, problem)
    want = _outcome(talloc._pod_fits_group_constraints_py, ttypes, problem)
    assert got == want
    assert got["fits"]
    assert len(got["placed"][("running_containers", "c0")]) == 1
    assert len(got["placed"][("init_containers", "c0")]) == 2


def _refuse_native(monkeypatch):
    def refuse(payload):
        raise AssertionError("the native core was called")
    monkeypatch.setattr(native, "grp_allocate", refuse)


def test_whitespace_token_takes_the_python_path(monkeypatch):
    """A request path with whitespace (annotations are user-writable)
    would inject protocol lines: the Python path answers, and counts."""
    _refuse_native(monkeypatch)
    problem = {"alloc": {f"{G}/gpu/dev0/cards": 1}, "used": {},
               "containers": [("m", False, {
                   f"{G}/gpu/r0/cards 1 -1\nR {G}/gpu/r0/memory": 999})]}
    before = metrics.NATIVE_FALLBACKS.value
    got = _outcome(talloc.pod_fits_group_constraints, ttypes, problem)
    assert metrics.NATIVE_FALLBACKS.value == before + 1
    assert got == _outcome(jalloc._pod_fits_group_constraints_py, jtypes,
                           problem)
    assert talloc._native_request(*_objects(ttypes, problem)) is None


def test_exotic_scorer_takes_the_python_path(monkeypatch):
    """A node scorer that resolves to neither leftover nor enum has no
    kind in the protocol: the Python path answers, and counts."""
    _refuse_native(monkeypatch)
    node, pod_info = _objects(ttypes, {
        "alloc": {f"{G}/gpu/dev0/cards": 1}, "used": {}, "containers": []})
    node.scorer[f"{G}/gpu/dev0/cards"] = 7
    before = metrics.NATIVE_FALLBACKS.value
    assert talloc.pod_fits_group_constraints(node, pod_info, True) == \
        (True, [], 0.0)
    assert metrics.NATIVE_FALLBACKS.value == before + 1
    assert "allocator_native_fallbacks_total" in metrics.prometheus_text()
    metrics.reset_all()
    assert metrics.NATIVE_FALLBACKS.value == 0


def test_failed_build_raises_with_the_compilers_output(tmp_path,
                                                        monkeypatch):
    cxx = tmp_path / "bin" / "g++"
    cxx.parent.mkdir()
    cxx.write_text("#!/bin/sh\necho 'grpalloc.cpp:1: error: no such luck' "
                   ">&2\nexit 3\n")
    cxx.chmod(0o755)
    monkeypatch.setenv("PATH", str(cxx.parent))
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(native, "_grp_lib", None)
    with pytest.raises(RuntimeError, match="build failed") as exc:
        native.load_grpalloc()
    assert "no such luck" in str(exc.value) and "exit 3" in str(exc.value)
    # no fallback: the search and the engine's device scheduler raise too
    node, pod_info = _objects(ttypes, _problems()[0])
    before = metrics.NATIVE_FALLBACKS.value
    with pytest.raises(RuntimeError, match="no such luck"):
        talloc.pod_fits_group_constraints(node, pod_info, True)
    with pytest.raises(RuntimeError, match="no such luck"):
        GPUScheduler()
    assert metrics.NATIVE_FALLBACKS.value == before
    assert not list((tmp_path / "build").rglob("*.so"))


def test_build_uses_the_gxx_on_path_not_cxx(tmp_path, monkeypatch):
    """The library joins a process that already holds the system's
    libstdc++, so it is built by the g++ on PATH: a $CXX naming another
    toolchain is not read."""
    monkeypatch.setenv("CXX", "/bin/false")
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(native, "_grp_lib", None)
    native.load_grpalloc()
    assert list((tmp_path / "build").rglob("libgrpalloc.so"))
    assert native.grp_allocate("E\n").startswith("FITS 1\n")


def test_the_build_key_names_the_compiler(tmp_path, monkeypatch):
    """A library that another g++ built sits under another key: a change
    of compiler, by path or by version, rebuilds instead of reusing."""
    real = native._hashed_path(native.GRPALLOC_SOURCE, "libgrpalloc.so")
    keys = set()
    for version in ("g++ (Other) 9.9.9", "g++ (Other) 9.9.10"):
        cxx = tmp_path / version.split()[-1] / "g++"
        cxx.parent.mkdir()
        cxx.write_text(f"#!/bin/sh\necho '{version}'\n")
        cxx.chmod(0o755)
        monkeypatch.setenv("PATH", str(cxx.parent))
        assert native._compiler() == (str(cxx), version)
        keys.add(native._hashed_path(native.GRPALLOC_SOURCE,
                                     "libgrpalloc.so"))
    assert len(keys) == 2 and real not in keys


def test_library_is_built_into_the_build_tree():
    lib = native.load_grpalloc()
    assert native.load_grpalloc() is lib
    path = native._hashed_path(native.GRPALLOC_SOURCE, "libgrpalloc.so")
    assert path.exists() and path.parent.parent == native.BUILD_ROOT


def test_native_error_and_desync_raise(monkeypatch):
    with pytest.raises(RuntimeError, match="unknown tag: X"):
        native.grp_allocate("X bogus\nE\n")
    node, pod_info = _objects(ttypes, _problems()[0])
    monkeypatch.setattr(native, "grp_allocate",
                        lambda payload: "FITS 1\nSCORE 0.5\n")
    with pytest.raises(RuntimeError, match="0 placements for 1"):
        talloc.pod_fits_group_constraints(node, pod_info, True)
    monkeypatch.setattr(native, "grp_allocate",
                        lambda payload: "FITS 1\nBOGUS\n")
    with pytest.raises(RuntimeError, match="unexpected reply line"):
        talloc.pod_fits_group_constraints(node, pod_info, True)


def test_concurrent_searches_agree_with_serial():
    """The fit pool's threads search at once, each call with the GIL
    dropped: 16 threads at a 1 us switch interval get the serial answers,
    and a failing call's message (thread-local in the core) names its own
    request."""
    problems = _problems()[:48]
    payloads = [talloc._native_request(*_objects(ttypes, p))[0]
                for p in problems]
    serial = [native.grp_allocate(p) for p in payloads]
    errors, mismatches = [], []

    def worker(k):
        for rep in range(10):
            for i in range(k % 3, len(payloads), 3):
                if native.grp_allocate(payloads[i]) != serial[i]:
                    mismatches.append((k, i))
            try:
                native.grp_allocate(f"Q{k}x{rep} bogus\nE\n")
            except RuntimeError as err:
                errors.append((f"unknown tag: Q{k}x{rep}", str(err)))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(k,))
                   for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert not mismatches
    assert len(errors) == 160 and all(want in got for want, got in errors)


def test_engine_searches_on_an_hgx_cluster_all_go_native(monkeypatch,
                                                          counted):
    """The port's engine on its default path over 4 HGX hosts: pods of 1,
    2, 4 and 8 cards bind, every search goes to the core, none to
    Python."""
    api, _, sched = cluster("port", *(fake.hgx_h100_inventory(h)
                                      for h in range(4)),
                            monkeypatch=monkeypatch)
    before = metrics.NATIVE_FALLBACKS.value
    sizes = (1, 2, 4, 8, 8, 4, 2, 1)
    for i, cards in enumerate(sizes):
        api.create_pod(pod(f"p{i}", cards))
    sched.run_until_idle()
    for i, cards in enumerate(sizes):
        node, alloc = placement(api, f"p{i}")
        assert node is not None, f"p{i} unbound"
        assert sum(p.endswith("/cards") for p in alloc["main"].values()) \
            == cards
    assert len(counted) >= len(sizes)
    assert metrics.NATIVE_FALLBACKS.value == before
