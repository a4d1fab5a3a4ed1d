"""The port's interleaving explorer (`kubegpu_tpu_torch/analysis/explore.py`,
`schedules.py`) and its race twins over GPU cards.

Three layers, as in the JAX package's `tests/test_explore.py`:

1. The explorer's mechanics, each run under both packages' explorers
   (determinism, exact replay from memory and from disk, the archive
   directory, sleep-set pruning, deadlock detection, a foreign real thread
   refused, virtual time), and the port's explorer held to the JAX one: the
   same scenario and seed explore the same schedules and fail at the same
   index with the same decisions.
2. Safety properties explored on the port's real code with a ledger keyed
   by card, ``(node, grammar.gpu_prefix_from_path)``: card conservation in
   ``SchedulerCache``, a bound pod's allocation immutable and gangs atomic
   at the port's arbiter, seq-exact watch delivery through ``_EventLog``,
   the stream push surviving a reconnect, repair eviction against a bind.
   Each mutant twin (the fix mutated back out) is rediscovered within a
   fixed budget; each clean class passes every schedule. Where the port
   takes the JAX module's inputs (the TPU twins of `tests/torch_api.py`),
   the port's exploration equals the JAX one schedule for schedule.
3. The sharded-replica commit race: a competing replica's commit lands
   between a replica's plan and its bind. With the bind written as two
   requests the losing attempt's allocation stays stamped on the pending
   pod and every replan fails on the taken card; the engine's atomic bind
   leaves nothing behind and the pod binds on another card.

The explorers refuse nesting only within themselves, and the JAX one's
gate (``startswith("kubegpu_tpu")``) also virtualizes the port's locks: no
test here runs one explorer inside the other.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
import types

import pytest

pytest.importorskip("torch")

from kubegpu_tpu import metrics as jax_metrics  # noqa: E402
from kubegpu_tpu.analysis import explore as jax_ex  # noqa: E402
from kubegpu_tpu.analysis import schedules as jax_sch  # noqa: E402
from kubegpu_tpu.cluster.apiserver import Conflict as JaxConflict  # noqa: E402
from kubegpu_tpu.cluster.apiserver import \
    InMemoryAPIServer as JaxAPIServer  # noqa: E402
from kubegpu_tpu.core import grammar as jax_grammar  # noqa: E402
from kubegpu_tpu.scheduler.cache import \
    SchedulerCache as JaxCache  # noqa: E402
from kubegpu_tpu.scheduler.queue import \
    SchedulingQueue as JaxQueue  # noqa: E402
from kubegpu_tpu_torch import metrics  # noqa: E402
from kubegpu_tpu_torch.analysis import explore as ex  # noqa: E402
from kubegpu_tpu_torch.analysis import races  # noqa: E402
from kubegpu_tpu_torch.analysis import schedules as sch  # noqa: E402
from kubegpu_tpu_torch.cluster.apiserver import InMemoryAPIServer  # noqa: E402
from kubegpu_tpu_torch.core import grammar  # noqa: E402
from kubegpu_tpu_torch.scheduler.cache import SchedulerCache  # noqa: E402
from kubegpu_tpu_torch.scheduler.core import Scheduler  # noqa: E402
from kubegpu_tpu_torch.scheduler.queue import SchedulingQueue  # noqa: E402
from tests import test_explore as jax_twins  # noqa: E402
from tests import torch_api as ta  # noqa: E402

# A deep run (KGTPU_EXPLORE_DEEP=1) widens every budget, as the JAX suite's
BUDGET = 8000 if os.environ.get("KGTPU_EXPLORE_DEEP", "") not in ("", "0") \
    else 1000
PREEMPTIONS = 2

PACKAGES = {"jax": types.SimpleNamespace(ex=jax_ex, sch=jax_sch,
                                         queue=JaxQueue),
            "port": types.SimpleNamespace(ex=ex, sch=sch,
                                          queue=SchedulingQueue)}


@pytest.fixture
def fresh_metric_children(monkeypatch):
    """Both packages' labeled metric families without children: a child
    made inside an exploration keeps the cooperative lock it was made
    with, so whether a family's child already exists (and how it was
    made) depends on the tests run before. Emptied, each family makes its
    child in the first schedule under either explorer, and the families
    get their children back afterwards."""
    for module in (jax_metrics, metrics):
        for family in vars(module).values():
            if isinstance(getattr(family, "_children", None), dict):
                monkeypatch.setattr(family, "_children", {})


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    """Each mechanics test runs under both packages' explorers."""
    return PACKAGES[request.param]


# ---- the seams import nothing of JAX -----------------------------------------

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEAM_MODULES = ("analysis.explore", "analysis.schedules", "analysis.races",
                "scheduler.queue",
                "scheduler.cache", "scheduler.core", "scheduler.lifecycle",
                "scheduler.quota", "scheduler.repair", "cluster.lease",
                "cluster.apiserver", "cluster.httpapi", "cluster.stream",
                "cluster.wal", "cluster.apf")


@pytest.mark.parametrize("name", SEAM_MODULES)
def test_a_seam_module_alone_loads_no_jax(name):
    """Each module that now imports ``probe``, imported alone in a fresh
    interpreter, leaves jax and every kubegpu_tpu.* out of sys.modules."""
    code = (f"import sys, kubegpu_tpu_torch.{name}\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'kubegpu_tpu')]\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]


# ---- explorer mechanics -----------------------------------------------------


def lost_update_scenario_of(xmod):
    def lost_update_scenario():
        """The textbook race: an unsynchronized read-modify-write with a
        probe marking the gap."""
        state = {"n": 0}

        def inc():
            v = state["n"]
            xmod.probe("between-read-and-write")
            state["n"] = v + 1

        def invariant():
            assert state["n"] == 2, f"lost update: n={state['n']}"

        return [inc, inc], invariant
    return lost_update_scenario


def guarded_scenario_of(xmod):
    def guarded_scenario():
        state = {"n": 0}
        lock = xmod.Lock()

        def inc():
            with lock:
                v = state["n"]
                xmod.probe("in-region")
                state["n"] = v + 1

        def invariant():
            assert state["n"] == 2

        return [inc, inc], invariant
    return guarded_scenario


def ab_ba_scenario_of(xmod):
    def ab_ba_scenario():
        a, b = xmod.Lock(), xmod.Lock()

        def t1():
            with a:
                xmod.probe("t1-holds-a")
                with b:
                    pass

        def t2():
            with b:
                xmod.probe("t2-holds-b")
                with a:
                    pass

        return [t1, t2], None
    return ab_ba_scenario


def queue_scenario_of(queue_cls):
    def queue_scenario():
        q = queue_cls()
        got = []

        def popper():
            got.append(q.pop(timeout=2.0))

        def pusher():
            q.push({"metadata": {"name": "p0"}, "spec": {}})

        def invariant():
            assert got and got[0] is not None, "push lost or pop starved"
            assert got[0]["metadata"]["name"] == "p0"

        return [popper, pusher], invariant
    return queue_scenario


def test_explorer_finds_the_textbook_lost_update(pkg):
    res = pkg.sch.explore(lost_update_scenario_of(pkg.ex), max_schedules=50,
                          seed=0)
    assert res.failure is not None
    assert res.failure.kind == "invariant"
    assert "lost update" in res.failure.summary


def test_same_seed_produces_identical_exploration(pkg):
    a = pkg.sch.explore(lost_update_scenario_of(pkg.ex), max_schedules=50,
                        seed=3)
    b = pkg.sch.explore(lost_update_scenario_of(pkg.ex), max_schedules=50,
                        seed=3)
    assert a.signature() == b.signature()
    assert a.failure.decisions == b.failure.decisions
    assert a.schedules == b.schedules


def test_recorded_trace_replays_to_the_same_failure(pkg):
    scenario = lost_update_scenario_of(pkg.ex)
    res = pkg.sch.explore(scenario, max_schedules=50, seed=0)
    for _ in range(2):  # replay is itself deterministic
        again = pkg.sch.replay(scenario, res.failure)
        assert again.summary == res.failure.summary
        assert again.decisions == res.failure.decisions


def test_failure_trace_serializes_and_replays_from_disk(pkg, tmp_path):
    scenario = lost_update_scenario_of(pkg.ex)
    res = pkg.sch.explore(scenario, max_schedules=50, seed=0)
    path = tmp_path / "trace.json"
    res.failure.dump(str(path))
    loaded = pkg.sch.Failure.load(str(path))
    assert loaded.decisions == res.failure.decisions
    assert json.loads(path.read_text())["kind"] == "invariant"
    again = pkg.sch.replay(scenario, loaded)
    assert again.summary == res.failure.summary


def test_explore_archives_failing_trace_when_dir_configured(
        pkg, tmp_path, monkeypatch):
    monkeypatch.setenv("KGTPU_EXPLORE_TRACE_DIR", str(tmp_path))
    pkg.sch.explore(lost_update_scenario_of(pkg.ex), max_schedules=50,
                    seed=5)
    files = sorted(os.listdir(tmp_path))
    assert len(files) == 1 and \
        files[0].startswith("lost_update_scenario-seed5-s"), files
    loaded = pkg.sch.Failure.load(str(tmp_path / files[0]))
    assert loaded.kind == "invariant"


def test_locked_twin_is_clean_and_pruning_helps(pkg):
    scenario = guarded_scenario_of(pkg.ex)
    pruned = pkg.sch.explore(scenario, max_schedules=500, seed=0)
    assert pruned.ok and pruned.exhausted
    full = pkg.sch.explore(scenario, max_schedules=500, seed=0, prune=False)
    assert full.ok
    assert pruned.schedules - pruned.pruned <= full.schedules


def test_deadlock_is_detected_with_trace(pkg):
    res = pkg.sch.explore(ab_ba_scenario_of(pkg.ex), max_schedules=200,
                          seed=0)
    assert res.failure is not None and res.failure.kind == "deadlock"
    assert "blocked" in res.failure.summary


def test_foreign_real_thread_touch_is_rejected_loudly(pkg):
    """A scenario that spawns a REAL OS thread which touches a cooperative
    primitive mid-run would silently break the serialization model: the
    primitive rejects it with ExploreError instead."""
    errs = []

    def scenario():
        lock = pkg.ex.Lock()

        def body():
            def foreign():
                try:
                    with lock:
                        pass
                except pkg.ex.ExploreError as e:
                    errs.append(e)

            t = threading.Thread(target=foreign)
            t.start()
            t.join()

        return [body], None

    pkg.sch.explore(scenario, max_schedules=5, seed=0)
    assert errs, "foreign real-thread touch was not rejected"
    assert "cannot serialize" in str(errs[0])


def test_virtual_time_drives_queue_pop_timeout_deterministically(pkg):
    """The port's ``SchedulingQueue.pop`` polls a Condition with deadlines
    on the monotonic clock; under either explorer (the JAX gate virtualizes
    the port's locks too) the clock is virtual, so a pop racing a push
    explores deterministically and a starved pop times out without
    wall-clock sleeping."""
    t0 = time.monotonic()
    res = pkg.sch.explore(queue_scenario_of(SchedulingQueue),
                          max_schedules=BUDGET, seed=0)
    assert res.ok, res.failure.render()
    assert res.exhausted
    # 2-second virtual timeouts explored in real milliseconds
    assert time.monotonic() - t0 < 30.0


@pytest.mark.parametrize("case", ["lost_update", "guarded", "unpruned",
                                  "deadlock", "queue"])
@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.usefixtures("fresh_metric_children")
def test_port_explorer_equals_the_jax_explorer(case, seed):
    """The same scenario and seed: the same schedules in the same order,
    and a failure at the same index with the same decisions."""
    def run(p):
        kw = {"max_schedules": 500, "seed": seed}
        scenario = {"lost_update": lost_update_scenario_of,
                    "guarded": guarded_scenario_of,
                    "unpruned": guarded_scenario_of,
                    "deadlock": ab_ba_scenario_of}.get(case)
        if case == "queue":
            return p.sch.explore(queue_scenario_of(p.queue), **kw)
        if case == "unpruned":
            kw["prune"] = False
        return p.sch.explore(scenario(p.ex), **kw)

    port, jax = run(PACKAGES["port"]), run(PACKAGES["jax"])
    assert port.signature() == jax.signature()
    assert (port.schedules, port.pruned, port.exhausted) == \
        (jax.schedules, jax.pruned, jax.exhausted)
    assert (port.failure is None) == (jax.failure is None)
    if port.failure is not None:
        assert port.failure.schedule_index == jax.failure.schedule_index
        assert port.failure.decisions == jax.failure.decisions
        assert port.failure.kind == jax.failure.kind


# ---- card conservation in the cache ------------------------------------------


def card_key(path: str):
    """The physical-card key of an allocation path: the port's for GPU
    spellings, the JAX grammar's for their TPU twins."""
    return grammar.gpu_prefix_from_path(path) or \
        jax_grammar.chip_prefix_from_path(path)


def test_explorer_rediscovers_assume_on_charged_race():
    scenario = races.conservation(races.AssumeOnChargedCache)
    res = sch.explore(scenario, max_schedules=BUDGET,
                      preemption_bound=PREEMPTIONS, seed=0)
    assert res.failure is not None, (
        f"mutant not found in {res.schedules} schedules")
    assert "card accounting corrupted" in res.failure.summary
    again = sch.replay(races.conservation(races.AssumeOnChargedCache),
                       res.failure)
    assert again.summary == res.failure.summary


def test_explorer_rediscovers_lost_conflict_vs_watch_event_race():
    res = sch.explore(races.conservation(races.LostConflictCache),
                      max_schedules=BUDGET, preemption_bound=PREEMPTIONS,
                      seed=0)
    assert res.failure is not None, (
        f"mutant not found in {res.schedules} schedules")
    assert "card accounting corrupted" in res.failure.summary


def test_unmutated_cache_passes_conservation_exploration_clean():
    res = sch.explore(races.conservation(SchedulerCache),
                      max_schedules=BUDGET, preemption_bound=PREEMPTIONS,
                      seed=0)
    assert res.ok, res.failure.render()
    assert res.exhausted, (
        f"budget too small to certify: {res.schedules} schedules run")


# ---- the arbiter: immutable allocations, atomic gangs -------------------------


def test_explorer_rediscovers_bound_annotation_rewrite_race():
    res = sch.explore(races.annotation_rewrite(races.UnguardedAPIServer),
                      max_schedules=BUDGET, preemption_bound=PREEMPTIONS,
                      seed=0)
    assert res.failure is not None, (
        f"mutant not found in {res.schedules} schedules")
    assert "rewritten" in res.failure.summary


def test_unmutated_apiserver_passes_rewrite_exploration_clean():
    res = sch.explore(races.annotation_rewrite(InMemoryAPIServer),
                      max_schedules=BUDGET, preemption_bound=PREEMPTIONS,
                      seed=0)
    assert res.ok, res.failure.render()
    assert res.exhausted


def test_explorer_finds_gang_split_when_atomicity_mutated_out():
    res = sch.explore(races.gang_atomicity(races.MemberwiseBindAPIServer),
                      max_schedules=BUDGET, preemption_bound=PREEMPTIONS,
                      seed=0)
    assert res.failure is not None, (
        f"mutant not found in {res.schedules} schedules")
    assert "gang split" in res.failure.summary


def test_unmutated_arbiter_keeps_gangs_atomic_across_schedules():
    res = sch.explore(races.gang_atomicity(InMemoryAPIServer),
                      max_schedules=BUDGET, preemption_bound=PREEMPTIONS,
                      seed=0)
    assert res.ok, res.failure.render()
    assert res.exhausted


# ---- the TPU twins: the port's exploration equals the JAX one ---------------


@pytest.mark.parametrize("port_cls, jax_cls", [
    (SchedulerCache, JaxCache),
    (races.AssumeOnChargedCache, jax_twins.AssumeOnChargedCache),
    (races.LostConflictCache, jax_twins.LostConflictCache)],
    ids=["clean", "assume_on_charged", "lost_conflict"])
@pytest.mark.usefixtures("fresh_metric_children")
def test_conservation_exploration_equals_the_jax_one(port_cls, jax_cls):
    """The port's cache over GPU cards and the JAX cache over their TPU
    twins: the same lock structure and seams give the same schedules, and
    a mutant fails at the same index with the same decisions."""
    kw = {"max_schedules": 200, "preemption_bound": 2, "seed": 0}
    port = sch.explore(races.conservation(port_cls), **kw)
    jax = jax_sch.explore(races.conservation(
        jax_cls, spell=ta.twin, key=card_key), **kw)
    assert port.signature() == jax.signature()
    assert (port.failure is None) == (jax.failure is None)
    if port.failure is not None:
        assert port.failure.schedule_index == jax.failure.schedule_index
        assert port.failure.decisions == jax.failure.decisions


@pytest.mark.parametrize("port_cls, jax_cls", [
    (InMemoryAPIServer, JaxAPIServer),
    (races.UnguardedAPIServer, jax_twins.UnguardedAPIServer)],
    ids=["clean", "unguarded"])
@pytest.mark.usefixtures("fresh_metric_children")
def test_annotation_rewrite_exploration_equals_the_jax_one(port_cls,
                                                           jax_cls):
    kw = {"max_schedules": 200, "preemption_bound": 2, "seed": 0}
    port = sch.explore(races.annotation_rewrite(port_cls), **kw)
    jax = jax_sch.explore(races.annotation_rewrite(
        jax_cls, spell=ta.twin, conflict=JaxConflict), **kw)
    assert port.signature() == jax.signature()
    assert (port.failure is None) == (jax.failure is None)
    if port.failure is not None:
        assert port.failure.schedule_index == jax.failure.schedule_index
        assert port.failure.decisions == jax.failure.decisions


# ---- seq-exact watch delivery and the stream push ----------------------------


def test_watch_log_is_seq_exact_under_interleaved_mutations():
    """Two mutators race a resuming watch consumer through the port's
    `_EventLog`: in every schedule the consumer sees strictly increasing
    sequence numbers and ends with every object delivered."""
    res = sch.explore(races.watch_log(), max_schedules=BUDGET,
                      preemption_bound=1, seed=0)
    assert res.ok, res.failure.render()


def test_stream_push_reconnect_never_drops_or_doubles_deltas():
    """The port's stream-wire fan-out under a reconnect racing live
    mutations never drops or doubles a delta (`races.stream_reconnect`)."""
    res = sch.explore(races.stream_reconnect(), max_schedules=BUDGET,
                      preemption_bound=PREEMPTIONS, seed=0)
    assert res.ok, res.failure.render()


# ---- repair eviction against a racing bind ----------------------------------


def test_explorer_rediscovers_forgetful_repair_double_charge():
    scenario = races.repair_vs_bind(races.ForgetfulEvictRepair)
    res = sch.explore(scenario, max_schedules=BUDGET,
                      preemption_bound=PREEMPTIONS, seed=0)
    assert res.failure is not None, (
        f"mutant not found in {res.schedules} schedules")
    assert "double-charged" in res.failure.summary
    res2 = sch.explore(races.repair_vs_bind(races.ForgetfulEvictRepair),
                       max_schedules=BUDGET, preemption_bound=PREEMPTIONS,
                       seed=0)
    assert res2.failure is not None
    assert res2.failure.schedule_index == res.failure.schedule_index


def test_unmutated_repair_eviction_preserves_card_conservation():
    res = sch.explore(races.repair_vs_bind(races.CorrectRepairEvict),
                      max_schedules=BUDGET, preemption_bound=PREEMPTIONS,
                      seed=0)
    assert res.ok, res.failure.render()
    assert res.exhausted


# ---- the sharded-replica commit race -----------------------------------------


def test_explorer_rediscovers_the_stale_stamp_of_a_two_write_bind():
    """The bind written as two requests (the engine before its repair): a
    competing replica's commit between the stamp and the binding leaves the
    lost allocation on the pending pod, and the pod never binds."""
    res = sch.explore(races.shard_commit_race(races.TwoWriteBindScheduler),
                      max_schedules=races.CARD_BUDGET, preemption_bound=1,
                      seed=0)
    assert res.failure is not None, (
        f"mutant not found in {res.schedules} schedules")
    assert "victim never bound" in res.failure.summary


def test_the_atomic_bind_survives_the_shard_commit_race():
    """Every schedule with one preemption: the engine's own bind."""
    res = sch.explore(races.shard_commit_race(Scheduler),
                      max_schedules=races.CARD_BUDGET, preemption_bound=1,
                      seed=0)
    assert res.ok, res.failure.render()
    assert res.exhausted


def test_explorer_rediscovers_the_kept_stamp_of_a_refused_extender_bind():
    """A bind-verb extender still writes the stamp, then binds: when it
    refuses the bind (a competing replica took the card) and the stamp
    stays on the pending pod, the pod never binds."""
    res = sch.explore(
        races.shard_commit_race(races.KeptStampScheduler, extender_bind=True),
        max_schedules=races.CARD_BUDGET, preemption_bound=1, seed=0)
    assert res.failure is not None, (
        f"mutant not found in {res.schedules} schedules")
    assert "victim never bound" in res.failure.summary


def test_the_withdrawn_stamp_survives_the_extender_commit_race():
    """Every schedule with one preemption: the engine with a bind-verb
    extender, whose refused bind withdraws the stamp."""
    res = sch.explore(races.shard_commit_race(Scheduler, extender_bind=True),
                      max_schedules=races.CARD_BUDGET, preemption_bound=1,
                      seed=0)
    assert res.ok, res.failure.render()
    assert res.exhausted


# ---- the acceptance budget ---------------------------------------------------


@pytest.mark.parametrize("twin", [t for t in races.catalog()
                                  if t.needle is not None
                                  and t.budget == races.CARD_BUDGET],
                         ids=lambda t: t.name)
def test_mutants_found_within_small_deterministic_budget(twin):
    """Each card mutant is rediscovered within 200 schedules at preemption
    bound 2, seed 0: what lets the suite hold these races down
    deterministically."""
    assert (twin.budget, twin.bound) == (200, 2)
    row = races.run_twin(twin)
    assert row["failing_index"] < 200


CARD_TWINS = ("conservation", "annotation_rewrite", "gang_atomicity",
              "repair_vs_bind")


@pytest.mark.parametrize("twin", [t for t in races.catalog()
                                  if t.name.startswith(CARD_TWINS)],
                         ids=lambda t: t.name)
def test_the_card_twins_hold_on_a_one_card_node(twin):
    """The card twins as the chip run builds them on a machine with one
    card: that card's path contended (here a card of another fake host,
    under another group), a fake HGX card beside it."""
    cards = [races.hgx_cards(5)[3], races.hgx_cards(0)[0]]
    races.run_twin(next(t for t in races.catalog(cards)
                        if t.name == twin.name))


@pytest.mark.slow
def test_deep_exploration_of_clean_scenarios():
    """The deep sweep: every clean scenario explored with the deep budget
    and a wider preemption bound."""
    for scenario in (
            races.conservation(SchedulerCache),
            races.annotation_rewrite(InMemoryAPIServer),
            races.gang_atomicity(InMemoryAPIServer),
            races.repair_vs_bind(races.CorrectRepairEvict)):
        res = sch.explore(scenario, max_schedules=8000,
                          preemption_bound=3, seed=0)
        assert res.ok, f"{scenario.__name__}: {res.failure.render()}"
