"""The port's mutation engine (``kubegpu_tpu_torch/analysis/mutate.py``)
and its CLI: tests/test_analysis.py's mutation tests over the port's own
mutant ids and GPU kill suite, the site enumerators held against the JAX
package's on one fixture function, the in-process application leaving
the tree and the process as it found them, and the full sweep with no
unwaived survivor."""

import ast
import hashlib
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

from kubegpu_tpu.analysis import mutate as jax_mutate  # noqa: E402
from kubegpu_tpu_torch import metrics  # noqa: E402
from kubegpu_tpu_torch.analysis import explore, mutate  # noqa: E402
from kubegpu_tpu_torch.scheduler import cache, vectorized  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPS = {"cmp", "boundary", "maskop", "minmax", "dropcall"}

FIXTURE = '''
def kernel(rows, mask, cache, n):
    probe("fixture.kernel")
    keep = (rows & mask) | (rows & ~mask)
    if len(rows) >= 4 and n != 0:
        keep &= mask
    cache.store(n, keep)
    cache.record(1, 0)
    for i in range(2):
        n = max(n, i + 1)
    return all(keep) if n in rows else min(n, 64 // 2)
'''


@pytest.fixture(scope="module")
def refs():
    return mutate.enumerate_mutants()


def _sites(module, source):
    tree = ast.parse(source)
    fn = tree.body[0]
    sites = [site for operator in module._OPERATORS
             for site in operator(fn.name, fn)]
    return module._refs_for("pkg.fixture", sites)


def test_mutant_enumeration_is_deterministic_and_unique(refs):
    again = mutate.enumerate_mutants()
    assert [r.mutant_id for r in refs] == [r.mutant_id for r in again]
    assert len({r.mutant_id for r in refs}) == len(refs)
    assert len(refs) > 100  # the targeted closure is rich enough to matter
    assert {r.op for r in refs} == OPS
    modules = {r.module for r in refs}
    assert modules == {m for m, _p in mutate.TARGETS}
    assert all(m.startswith("kubegpu_tpu_torch.scheduler.") for m in modules)
    assert not any("topology" in m for m in modules)


def test_site_enumerators_equal_the_jax_package_on_one_function():
    """Same operators, same snippets, same hash inputs: the same ids."""
    port = [(r.mutant_id, r.op, r.lineno, r.before, r.after)
            for r in _sites(mutate, FIXTURE)]
    jax = [(r.mutant_id, r.op, r.lineno, r.before, r.after)
           for r in _sites(jax_mutate, FIXTURE)]
    assert port == jax
    assert {op for _i, op, *_ in port} == OPS
    assert mutate._DROP_CALLS == jax_mutate._DROP_CALLS
    assert mutate._MAX_BOUNDARY_CONST == jax_mutate._MAX_BOUNDARY_CONST


def test_probe_seams_are_never_dropcall_sites(refs):
    """The explorer's seams sit inside the targets (the queue's batch
    intake) and no dropcall mutant deletes one."""
    dropped = [r.before for r in refs if r.op == "dropcall"]
    assert dropped and not any(b.startswith("probe(") for b in dropped)
    with open(os.path.join(REPO, "kubegpu_tpu_torch", "scheduler",
                           "queue.py"), encoding="utf-8") as fh:
        assert 'probe("queue.push_many")' in fh.read()
    assert not any(r.op == "dropcall" and "probe" in r.before
                   for r in _sites(mutate, FIXTURE))


def test_rebinding_reaches_the_port_only():
    """A mutant is rebound in every kubegpu_tpu_torch module that imported
    its names, and in no module of the JAX package."""
    assert mutate._in_package("kubegpu_tpu_torch")
    assert mutate._in_package("kubegpu_tpu_torch.scheduler.cache")
    assert not mutate._in_package("kubegpu_tpu")
    assert not mutate._in_package("kubegpu_tpu.scheduler.cache")
    assert not mutate._in_package("kubegpu_tpu_torchx")
    from kubegpu_tpu.scheduler import cache as jax_cache

    # any cache mutant re-executes the whole module: every function in it
    # is a new object, card_ids (which vectorized.py imports) among them
    ref = next(r for r in mutate.enumerate_mutants()
               if r.module.endswith(".cache"))
    original = cache.card_ids
    jax_names = dict(vars(jax_cache))
    patch = mutate.apply_mutant(ref)
    try:
        assert cache.card_ids is not original
        assert vectorized.card_ids is cache.card_ids  # from-imported name
        assert dict(vars(jax_cache)) == jax_names
    finally:
        patch.restore()
    assert cache.card_ids is original and vectorized.card_ids is original


def test_mutant_apply_and_restore_roundtrip(refs):
    """Applying the cache's mask mutant (the delta view's dirty-row union)
    makes the columns-mirror check fail; restoring brings the original
    objects back, leaves the sources byte for byte, and the kill suite
    passes on the clean tree again."""
    ref = next(r for r in refs if r.module.endswith(".cache")
               and r.op == "maskop")
    paths = [sys.modules[m].__file__ for m, _p in mutate.TARGETS]
    digests = [hashlib.sha256(open(p, "rb").read()).hexdigest()
               for p in paths]
    before = dict(vars(cache))
    patch = mutate.apply_mutant(ref)
    try:
        assert cache.SchedulerCache is not before["SchedulerCache"]
        failed = mutate._run_checks(60)
        assert failed == "columns-mirror", failed
    finally:
        patch.restore()
    assert dict(vars(cache)) == before
    assert [hashlib.sha256(open(p, "rb").read()).hexdigest()
            for p in paths] == digests
    assert mutate._run_checks(120) is None  # original tree clean again


def test_unknown_mutant_id_is_a_typed_error():
    with pytest.raises(mutate.MutationError):
        mutate.run_sweep(ids=["vectorized.nope:cmp:00000000"])
    with pytest.raises(mutate.MutationError):
        mutate.find_mutant("cache.nope:cmp:00000000")


def test_waivers_and_smoke_pins_reference_live_mutants(refs):
    """A waiver or smoke pin naming a mutant that no longer exists is a
    stale waiver — the same stance the unused-suppression audit takes.
    Every waiver says why; the smoke pins one mutant for each module and
    operator family that has one it can kill."""
    ids = {r.mutant_id for r in refs}
    stale = set(mutate.WAIVERS) - ids
    assert not stale, f"stale waivers: {sorted(stale)}"
    assert all(len(why.split()) >= 8 for why in mutate.WAIVERS.values())
    assert set(mutate.PINNED_SMOKE) <= ids
    assert mutate.PINNED_SMOKE, "the mutation smoke must pin something"
    assert not set(mutate.PINNED_SMOKE) & set(mutate.WAIVERS)
    by_id = {r.mutant_id: r for r in refs}
    pinned = [(by_id[i].module, by_id[i].op) for i in mutate.PINNED_SMOKE]
    assert len(pinned) == len(set(pinned)), "one pin per module x operator"
    killable = {(r.module, r.op) for r in refs
                if r.mutant_id not in mutate.WAIVERS}
    assert set(pinned) == killable


def test_cli_mutate_smoke_and_list_mutants():
    """`--list-mutants` is deterministic across invocations, and
    `--mutate --mutate-smoke` exits 0 with every pinned mutant killed."""
    argv = [sys.executable, "-m", "kubegpu_tpu_torch.analysis"]
    a = subprocess.run(argv + ["--list-mutants"], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    b = subprocess.run(argv + ["--list-mutants"], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert a.returncode == 0, a.stdout + a.stderr
    assert a.stdout == b.stdout
    assert "mutant(s):" in a.stdout
    assert "topology" not in a.stdout and "mesh" not in a.stdout
    smoke = subprocess.run(argv + ["--mutate", "--mutate-smoke"],
                           cwd=REPO, capture_output=True, text=True,
                           timeout=300)
    assert smoke.returncode == 0, smoke.stdout + smoke.stderr
    assert "0 survived" in smoke.stdout
    assert "kill rate 100.0%" in smoke.stdout


def test_pinned_smoke_mutants_all_killed():
    """The pinned subset end to end, in process: every pinned mutant
    dies, the report says which check killed it, and the sweep hands
    back the package's metrics and the explorer's state as it found
    them."""
    # the families the kill suite's engines move
    moved = (metrics.FIT_CACHE_HITS, metrics.FIT_CACHE_MISSES,
             metrics.FIT_VECTOR_PASS_MS, metrics.SCHED_PHASE_MS,
             metrics.SCHEDULE_ATTEMPTS)
    metrics.FIT_CACHE_HITS.inc(3)
    phase = metrics.SCHED_PHASE_MS.labels("filter")
    phase.observe(1.5)
    before = [m.snapshot() for m in moved]
    report = mutate.run_sweep(ids=list(mutate.PINNED_SMOKE))
    assert report["survived"] == 0, mutate.render_report(report)
    assert report["killed"] == len(mutate.PINNED_SMOKE)
    for m in report["mutants"]:
        assert m["status"] == "killed" and m["killed_by"]
    assert [m.snapshot() for m in moved] == before
    assert metrics.SCHED_PHASE_MS.labels("filter") is phase
    assert explore._ACTIVE is None


def test_sweep_refuses_to_run_inside_the_explorer(monkeypatch):
    monkeypatch.setattr(explore, "_ACTIVE", object())
    with pytest.raises(mutate.MutationError, match="explorer"):
        mutate.run_sweep(ids=list(mutate.PINNED_SMOKE[:1]))


def test_full_sweep_leaves_no_unwaived_survivor():
    report = mutate.run_sweep()
    assert report["survived"] == 0, mutate.render_report(report)
    assert report["skipped"] == 0
    assert report["waived"] == len(mutate.WAIVERS)
    assert report["killed"] + report["waived"] == report["total"]
    assert report["kill_rate"] == 1.0
    assert {m["killed_by"] for m in report["mutants"]
            if m["status"] == "killed"} <= {n for n, _c in mutate.KILL_CHECKS}
