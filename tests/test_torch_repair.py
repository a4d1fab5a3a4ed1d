"""The repair controller of the port (kubegpu_tpu_torch/scheduler/repair.py),
counting GPU cards.

Each scenario of tests/test_repair.py that reads no ICI link runs twice: the
JAX controller over its TPU mesh hosts (tests/test_repair.py's
``_gang_cluster``) and the port's over fake HGX hosts placed by the port's
engine, with a card (a chip) of the same gang failed. Both controllers must
make the same decisions — units, evictions, parked reasons, the events on
each member, the requeued copies — and the port's engine then rebinds the
gang off the failed card. The feasibility is chosen so that the JAX block
test and the port's host test agree: four hosts leave room, two full ones
leave none. The scenarios: a solo pod, a whole gang with its checkpoint
signal, park then replan on growth, the retry budget, PDB deferral, a member
deleted from outside, the storm recorder, determinism across runs and the
metrics. The JAX controller over the GPU fleet finds no card in the
degraded pod (ROADMAP Queue 3), and a dead-link stamp on a GPU node
repairs nothing (the port reads no link health)."""

import json

import pytest

pytest.importorskip("torch")

from kubegpu_tpu.node.backend import CHIP_DEGRADED, CHIP_FAILED  # noqa: E402
from kubegpu_tpu.scheduler import repair as jax_repair  # noqa: E402
from kubegpu_tpu_torch import metrics, obs  # noqa: E402
from kubegpu_tpu_torch.core import codec, grammar  # noqa: E402
from kubegpu_tpu_torch.node import fake  # noqa: E402
from kubegpu_tpu_torch.scheduler import repair  # noqa: E402
from kubegpu_tpu_torch.scheduler.lifecycle import \
    CHECKPOINT_REQUEST_ANNOTATION  # noqa: E402
from tests.test_faults import allocated_chips  # noqa: E402
from tests.test_repair import _gang_cluster  # noqa: E402
from tests.test_torch_gpu_e2e import GPUHost  # noqa: E402
from tests.torch_sched import PortAPI, cluster, pod  # noqa: E402

REPAIR_REASONS = ("CheckpointRequested", "Evicted", "Unrepairable")


def gpu_gang_cluster(monkeypatch, n_hosts=4, gang=31, size=2, cards=8,
                     labels=None):
    """``n_hosts`` HGX hosts and a bound gang of ``size`` pods of
    ``cards`` cards, placed by the port's engine: ``(api, hosts, sched,
    names)``."""
    api, hosts, sched = cluster(
        "port", *[fake.hgx_h100_inventory(host=i) for i in range(n_hosts)],
        monkeypatch=monkeypatch)
    names = [f"rg-{i}" for i in range(size)]
    for name in names:
        api.create_pod(pod(name, cards, gang_id=gang, gang_size=size,
                           labels=labels))
    assert drive(api, sched, names)
    return api, hosts, sched, names


def drive(api, sched, names, rounds=10):
    for _ in range(rounds):
        sched.run_until_idle()
        if all(api.get_pod(n)["spec"].get("nodeName") for n in names):
            return True
        sched.queue.move_all_to_active()
    return False


def cards_of(api, name):
    """``[(node, card UUID)]`` a bound pod holds."""
    p = api.get_pod(name)
    return [(p["spec"]["nodeName"], uuid)
            for uuid, _ in repair.allocated_card_ids(p)]


def fail_card(api, hosts, name, state=CHIP_FAILED):
    """Report the first card of ``name`` in ``state``, as its host's
    advertiser does: ``(node, UUID)``."""
    node, uuid = cards_of(api, name)[0]
    hosts[node].backend.set_chip_health(uuid, state)
    hosts[node].advertiser.advertise_once()
    return node, uuid


def fail_chip(api, advs, backends, name, state=CHIP_FAILED):
    node = api.get_pod(name)["spec"]["nodeName"]
    chip = allocated_chips(api, name)[0]
    backends[node].set_chip_health(chip, state)
    advs[node].advertise_once()
    return node, chip


def outcome(api, res, names):
    """What a tick decided, free of device ids: units, evictions, parked
    reasons, each member's repair events, and each member's state (bound,
    checkpoint request carried, gang intent kept)."""
    state = {}
    for name in names:
        try:
            p = api.get_pod(name)
        except KeyError:
            state[name] = "gone"
            continue
        ann = p["metadata"].get("annotations") or {}
        info = json.loads(ann[codec.POD_ANNOTATION_KEY])
        state[name] = (bool(p["spec"].get("nodeName")),
                       CHECKPOINT_REQUEST_ANNOTATION in ann,
                       info.get("requests", {}).get(grammar.RESOURCE_GANG))
    return {"repaired": sorted(map(str, res["repaired"])),
            "evicted": sorted(res["evicted"]),
            "parked": sorted(res["parked"].values()),
            "events": {n: [e["reason"] for e in
                           api.list_events(involved_name=n)
                           if e["reason"] in REPAIR_REASONS]
                       for n in names},
            "state": state}


def no_double_binds(api):
    seen = [(p["spec"]["nodeName"], uuid) for p in api.list_pods()
            if p["spec"].get("nodeName")
            for uuid, _ in repair.allocated_card_ids(p)]
    assert len(seen) == len(set(seen)), seen


@pytest.fixture
def twins(monkeypatch):
    """Build both clusters alike: ``twins(**kw)`` gives ``(jax, port)``,
    each ``(api, hosts-or-(advs, backends), sched, names)``; both engines
    stop at teardown."""
    made = []

    def build(n_hosts=4, size=2, chips=4, cards=8, labels=None):
        japi, advs, backends, jsched, names = _gang_cluster(
            n_hosts=n_hosts, size=size, chips=chips)
        made.append(jsched)
        if labels:
            for n in names:
                p = japi.get_pod(n)
                p["metadata"]["labels"] = dict(labels)
                japi.restore_object("pod", "modified", p)
        papi, hosts, psched, pnames = gpu_gang_cluster(
            monkeypatch, n_hosts=n_hosts, size=size, cards=cards,
            labels=labels)
        made.append(psched)
        assert names == pnames
        return (japi, (advs, backends), jsched, names), \
            (papi, hosts, psched, pnames)
    yield build
    for sched in made:
        sched.stop()


def test_allocated_card_ids_reads_uuids_and_prefixes(monkeypatch):
    api, _, sched, names = gpu_gang_cluster(monkeypatch, size=1, cards=2)
    try:
        got = repair.allocated_card_ids(api.get_pod(names[0]))
        assert len(got) == 2
        for uuid, prefix in got:
            assert prefix.endswith(f"/gpu/{uuid}")
        assert repair.allocated_card_ids({"metadata": {"annotations": {
            codec.POD_ANNOTATION_KEY: "[broken"}}}) == []
    finally:
        sched.stop()


def test_chip_failure_migrates_whole_gang_with_checkpoint(twins):
    (japi, (advs, backends), _, names), (papi, hosts, psched, _) = twins()
    fail_chip(japi, advs, backends, names[0])
    bad = fail_card(papi, hosts, names[0])
    jres = jax_repair.RepairController(japi).tick()
    rc = repair.RepairController(PortAPI(papi))
    pres = rc.tick()
    assert outcome(papi, pres, names) == outcome(japi, jres, names)
    assert sorted(pres["evicted"]) == names and rc.repaired_total == 1
    for name in names:
        assert outcome(papi, pres, names)["events"][name][:2] == \
            ["CheckpointRequested", "Evicted"]
    assert drive(papi, psched, names)
    flat = [c for n in names for c in cards_of(papi, n)]
    assert len(set(flat)) == 16 and bad not in flat
    no_double_binds(papi)
    assert rc.tick()["repaired"] == []


def test_the_checkpoint_request_names_the_gang_and_directory(monkeypatch):
    api, hosts, sched, names = gpu_gang_cluster(monkeypatch)
    try:
        fail_card(api, hosts, names[1])
        seen = {}

        class Recording(PortAPI):
            def update_pod_annotations(self, name, ann):
                seen[name] = json.loads(ann[CHECKPOINT_REQUEST_ANNOTATION])
                return PortAPI.__getattr__(self, "update_pod_annotations")(
                    name, ann)
        repair.RepairController(Recording(api)).tick()
        for name in names:
            assert seen[name]["gang"] == 31
            assert seen[name]["dir"] == f"ckpt/{name}"
            assert seen[name]["reason"].startswith("chip-failed:GPU-")
    finally:
        sched.stop()


def test_solo_pod_on_degraded_card_is_repaired(twins):
    (japi, (advs, backends), _, names), (papi, hosts, psched, _) = twins(
        size=1, chips=2, cards=2)
    fail_chip(japi, advs, backends, names[0], CHIP_DEGRADED)
    bad = fail_card(papi, hosts, names[0], CHIP_DEGRADED)
    jres = jax_repair.RepairController(japi).tick()
    pres = repair.RepairController(PortAPI(papi)).tick()
    assert outcome(papi, pres, names) == outcome(japi, jres, names)
    assert pres["evicted"] == names
    assert drive(papi, psched, names)
    assert bad not in cards_of(papi, names[0])
    no_double_binds(papi)


def test_no_feasible_target_parks_then_replans_on_growth(twins):
    """Two full hosts: a failed card leaves no host for one member, so the
    unit parks (still bound, typed reason in /debug/pod and an event);
    two more hosts join and the next tick repairs."""
    from tests.test_node_lifecycle import _mesh_host

    (japi, (advs, backends), _, names), (papi, hosts, psched, _) = twins(
        n_hosts=2)
    fail_chip(japi, advs, backends, names[0])
    bad = fail_card(papi, hosts, names[0])
    jrc = jax_repair.RepairController(japi)
    prc = repair.RepairController(PortAPI(papi))
    jres, pres = jrc.tick(), prc.tick()
    assert outcome(papi, pres, names) == outcome(japi, jres, names)
    assert list(pres["parked"].values()) == [repair.UNREPAIRABLE_NO_TARGET]
    assert all(papi.get_pod(n)["spec"].get("nodeName") for n in names)
    assert obs.explain_pod(names[0]).get("unrepairable", {}).get(
        "reason") == repair.UNREPAIRABLE_NO_TARGET
    # growth: two more hosts each
    for i, origin in ((2, (0, 2, 0)), (3, (2, 2, 0))):
        _mesh_host(japi, f"host{i}", origin, mesh_dims=(4, 4, 1))
        hosts[f"host{i}"] = GPUHost(papi, f"host{i}",
                                    fake.hgx_h100_inventory(host=i))
    jres, pres = jrc.tick(), prc.tick()
    assert outcome(papi, pres, names) == outcome(japi, jres, names)
    assert sorted(pres["evicted"]) == names and not pres["parked"]
    assert drive(papi, psched, names)
    assert bad not in [c for n in names for c in cards_of(papi, n)]
    assert "unrepairable" not in obs.explain_pod(names[0])
    no_double_binds(papi)


def test_retry_budget_exhaustion_parks_with_typed_reason(twins):
    (japi, (advs, backends), jsched, names), (papi, hosts, psched, _) = \
        twins()
    jsched.stop()
    psched.stop()

    class DeleteBroken:
        def __init__(self, api):
            self._api = api

        def __getattr__(self, name):
            return getattr(self._api, name)

        def delete_pod(self, name):
            raise RuntimeError("injected: delete unavailable")

    fail_chip(japi, advs, backends, names[0])
    fail_card(papi, hosts, names[0])
    clocks = [{"now": 100.0}, {"now": 100.0}]
    rcs = [jax_repair.RepairController(
               DeleteBroken(japi), clock=lambda: clocks[0]["now"],
               retry_budget=2),
           repair.RepairController(
               DeleteBroken(PortAPI(papi)), clock=lambda: clocks[1]["now"],
               retry_budget=2)]
    trace = [[], []]
    for _ in range(3):
        for rc, clock, log in zip(rcs, clocks, trace):
            res = rc.tick()
            state = next(iter(rc._units.values()))
            log.append((res["repaired"], sorted(res["parked"].values()),
                        state["attempts"], state["next_try"] - clock["now"]))
            clock["now"] = state["next_try"] + 0.01
    assert trace[0] == trace[1]
    assert trace[1][-1][1] == [repair.UNREPAIRABLE_BUDGET]
    assert trace[1][1][3] > trace[1][0][3]  # exponential backoff
    for name in names:
        assert papi.get_pod(name)["spec"].get("nodeName")


def test_pdb_state_and_blocking_helpers_equal_jax():
    from kubegpu_tpu.cluster.apiserver import InMemoryAPIServer

    api = InMemoryAPIServer()
    bound = []
    for i in range(4):
        p = pod(f"p{i}", 1, labels={"app": "training"})
        p["spec"]["nodeName"] = "host0"
        bound.append(p)
    for name, floor in (("abs", 3), ("pct", "50%"), ("malformed", "wat%")):
        api.create_pdb({"metadata": {"name": name},
                        "spec": {"selector": {"matchLabels":
                                              {"app": "training"}},
                                 "minAvailable": floor}})
    ours = repair.RepairController(PortAPI(api))._pdb_state(bound)
    assert ours == jax_repair.RepairController(api)._pdb_state(bound)
    assert sorted(s["allowed"] for s in ours) == [1, 2]
    gate = [{"selector": {"app": "training"}, "allowed": 1}]
    assert repair.RepairController._pdb_blocks(bound[:2], gate)
    assert not repair.RepairController._pdb_blocks(
        bound[:2], [dict(gate[0], allowed=2)])
    other = pod("other", 1)
    assert not repair.RepairController._pdb_blocks(
        [other], [dict(gate[0], allowed=0)])


def test_pdb_defers_repair_until_allowance_exists(twins):
    (japi, (advs, backends), _, names), (papi, hosts, psched, _) = twins(
        labels={"app": "training"})
    pdb = {"metadata": {"name": "train-pdb"},
           "spec": {"selector": {"matchLabels": {"app": "training"}},
                    "minAvailable": 2}}
    japi.create_pdb(pdb)
    papi.create_pdb(json.loads(json.dumps(pdb)))
    fail_chip(japi, advs, backends, names[0])
    fail_card(papi, hosts, names[0])
    jrc = jax_repair.RepairController(japi)
    prc = repair.RepairController(PortAPI(papi))
    jres, pres = jrc.tick(), prc.tick()
    assert outcome(papi, pres, names) == outcome(japi, jres, names)
    assert list(pres["parked"].values()) == [repair.DEFERRED_PDB]
    assert next(iter(prc._units.values()))["attempts"] == 0
    japi.delete_pdb("train-pdb")
    papi.delete_pdb("train-pdb")
    jres, pres = jrc.tick(), prc.tick()
    assert outcome(papi, pres, names) == outcome(japi, jres, names)
    assert sorted(pres["evicted"]) == names
    assert drive(papi, psched, names)
    no_double_binds(papi)


def test_externally_deleted_member_is_not_resurrected(twins):
    (japi, (advs, backends), _, names), (papi, hosts, _, _) = twins()
    fail_chip(japi, advs, backends, names[0])
    fail_card(papi, hosts, names[0])
    japi.delete_pod(names[1])
    papi.delete_pod(names[1])
    jres = jax_repair.RepairController(japi).tick()
    pres = repair.RepairController(PortAPI(papi)).tick()
    assert outcome(papi, pres, names) == outcome(japi, jres, names)
    assert pres["evicted"] == [names[0]] and len(pres["repaired"]) == 1
    with pytest.raises(KeyError):
        papi.get_pod(names[1])


def test_repair_storm_triggers_the_flight_recorder(tmp_path, monkeypatch):
    api, hosts, sched, names = gpu_gang_cluster(monkeypatch)
    try:
        obs.FLIGHT.configure(str(tmp_path), cooldown_s=0.0)
        fail_card(api, hosts, names[0])
        rc = repair.RepairController(PortAPI(api), storm_threshold=1)
        before = obs.FLIGHT.dumps
        assert len(rc.tick()["repaired"]) == 1
        assert obs.FLIGHT.dumps == before + 1
        dump = json.loads(
            next(tmp_path.glob("flight-*repair_storm.json")).read_text())
        assert dump["kind"] == "repair_storm"
    finally:
        obs.FLIGHT.configure(None)
        sched.stop()


def test_repair_is_deterministic_across_runs(monkeypatch):
    def once():
        api, hosts, sched, names = gpu_gang_cluster(monkeypatch)
        try:
            bad = fail_card(api, hosts, names[0])
            res = repair.RepairController(PortAPI(api)).tick()
            assert drive(api, sched, names)
            no_double_binds(api)
            return (bad, tuple(sorted(res["evicted"])),
                    tuple((n, tuple(sorted(cards_of(api, n))))
                          for n in names))
        finally:
            sched.stop()

    runs = [once() for _ in range(3)]
    assert runs[0] == runs[1] == runs[2]


def test_repair_metrics_count_outcomes(monkeypatch):
    api, hosts, sched, names = gpu_gang_cluster(monkeypatch)
    try:
        repaired = metrics.REPAIRS.labels("repaired").value
        latency = metrics.REPAIR_LATENCY_MS.n
        evictions = metrics.EVICTIONS.value
        fail_card(api, hosts, names[0])
        repair.RepairController(PortAPI(api)).tick()
        assert metrics.REPAIRS.labels("repaired").value == repaired + 1
        assert metrics.REPAIR_LATENCY_MS.n == latency + 1
        assert metrics.EVICTIONS.value == evictions + 2
        text = metrics.prometheus_text()
        assert 'scheduler_repairs_total{outcome="repaired"}' in text
    finally:
        sched.stop()


def test_the_jax_controller_finds_no_card_in_a_degraded_gpu_pod(
        monkeypatch):
    """[jax] The JAX controller reads TPU chip ids only: over the GPU
    fleet, a pod on a failed card is no repair unit (ROADMAP Queue 3);
    the port's repairs it."""
    api, hosts, sched, names = gpu_gang_cluster(monkeypatch)
    try:
        fail_card(api, hosts, names[0])
        assert jax_repair.allocated_chip_ids(api.get_pod(names[0])) == []
        jres = jax_repair.RepairController(api).tick()
        assert jres == {"repaired": [], "evicted": [], "parked": {}}
        pres = repair.RepairController(PortAPI(api)).tick()
        assert sorted(pres["evicted"]) == names
    finally:
        sched.stop()


def test_a_link_health_stamp_on_a_gpu_node_repairs_nothing(monkeypatch):
    """The port reads no link health: a dead-link mask stamped on the
    node of a bound gang's card starts no repair."""
    api, _, sched, names = gpu_gang_cluster(monkeypatch)
    try:
        node, uuid = cards_of(api, names[0])[0]
        meta = {"annotations": {}}
        codec.link_health_to_annotation(meta, {uuid: 0b1})
        api.patch_node_metadata(node, meta)
        assert codec.annotation_to_link_health(
            api.get_node(node)["metadata"]) == {uuid: 1}
        rc = repair.RepairController(PortAPI(api))
        assert rc.tick() == {"repaired": [], "evicted": [], "parked": {}}
        assert all(api.get_pod(n)["spec"].get("nodeName") for n in names)
    finally:
        sched.stop()


def test_the_controller_runs_on_its_loop_and_stops(monkeypatch):
    """``start`` runs ticks on a thread; a failed card is repaired and the
    gang rebinds while the loop runs; ``stop`` joins it."""
    import time

    api, hosts, sched, names = gpu_gang_cluster(monkeypatch)
    rc = repair.RepairController(PortAPI(api))
    try:
        bad = fail_card(api, hosts, names[0])
        rc.start(interval_s=0.02)
        deadline = time.monotonic() + 10
        while rc.repaired_total < 1 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert rc.repaired_total == 1
        assert drive(api, sched, names)
        assert bad not in [c for n in names for c in cards_of(api, n)]
    finally:
        rc.stop()
        sched.stop()
    assert not rc._thread.is_alive()
