"""The port's whole-backlog batch cycle (`kubegpu_tpu_torch/scheduler/
batch.py` and `Scheduler._schedule_backlog`) against the port's scalar
oracle (``KGTPU_BATCH=0 KGTPU_VECTORIZE=0``), as tests/test_vector_batch.py
holds the JAX one against the JAX serial engine; and the port's default
path against the JAX engine's default path carrying the port's plugin.

- Seeded streams and bursts created before the first pass place every
  pod on the same node with the same cards and leave the same events
  (failure reasons included) on both paths; gang and auto-topology pods
  take the serial route; losers park for retry.
- The class pass equals the serial filter and host choice; the class key
  is a strict content hash; the capacity ledger counts cards exactly;
  ``pop_many`` drains in ``pop``'s order.
- Against the JAX default path: the same placements for count-mode pods,
  one allocator search per pod class where the JAX path pays one per
  node, and two faults of the JAX path shown there and repaired in the
  port (a batch loser's FitError names only some nodes' reasons; an
  auto-topology pod is refused from a stale shape verdict).
"""

import random

import pytest

pytest.importorskip("torch")

from kubegpu_tpu.cluster.apiserver import InMemoryAPIServer  # noqa: E402
from kubegpu_tpu_torch import metrics  # noqa: E402
from kubegpu_tpu_torch.node import fake  # noqa: E402
from kubegpu_tpu_torch.scheduler import batch  # noqa: E402
from kubegpu_tpu_torch.scheduler.core import Scheduler  # noqa: E402
from kubegpu_tpu_torch.scheduler.queue import SchedulingQueue  # noqa: E402
from kubegpu_tpu_torch.scheduler.registry import (  # noqa: E402
    build_device_scheduler)
from tests.test_torch_gpu_e2e import GPUHost  # noqa: E402
from tests.test_torch_vectorized import (FLOORS,  # noqa: E402
                                         _count_searches, build_cluster,
                                         drive_stream)
from tests.torch_sched import PortAPI, cluster, placement, pod  # noqa: E402

PATHS = {"default": ("1", "1"), "oracle": ("0", "0")}


def engine(api, monkeypatch, path):
    vec, bat = PATHS[path]
    monkeypatch.setenv("KGTPU_VECTORIZE", vec)
    monkeypatch.setenv("KGTPU_BATCH", bat)
    sched = Scheduler(PortAPI(api), build_device_scheduler())
    assert sched._batch == (bat == "1")
    return sched


def outcome(api, names):
    return {n: (placement(api, n), sorted(
        (e["reason"], e["message"]) for e in api.list_events(n)))
        for n in names}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stream_placements_identical_to_the_oracle(seed, monkeypatch):
    got = {}
    for path in ("default", "oracle"):
        rng = random.Random(seed)
        api, _ = build_cluster(rng)
        sched = engine(api, monkeypatch, path)
        try:
            got[path] = drive_stream(api, sched, rng)
        finally:
            sched.stop()
    assert got["default"] == got["oracle"]


MIXED = (lambda: fake.hgx_h100_inventory(0), lambda: fake.pcie_h100_inventory(1),
         lambda: fake.hgx_h100_inventory(2), lambda: fake.rig_inventory(3),
         lambda: fake.hgx_h100_inventory(4), lambda: fake.pcie_h100_inventory(5))


def burst(seed, extra=()):
    """40 pods of 1, 2, 4 and 8 cards (memory floors, priorities; about
    120 cards asked of the fleet's 41) plus ``extra``, all created before
    the first pass."""
    rng = random.Random(seed)
    pods = [pod(f"b{i}", rng.choice([1, 1, 2, 2, 4, 8]),
                memory=rng.choice(FLOORS), priority=rng.choice([0, 0, 5]))
            for i in range(40)]
    return pods + list(extra)


def run_burst(monkeypatch, path, pods, engine_name="port"):
    api, _, sched = cluster(engine_name, *(inv() for inv in MIXED),
                            monkeypatch=monkeypatch, path=path)
    try:
        for p in pods:
            api.create_pod(p)
        sched.run_until_idle()
        return outcome(api, [p["metadata"]["name"] for p in pods])
    finally:
        sched.stop()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_a_burst_places_card_for_card_as_the_oracle(seed, monkeypatch):
    metrics.reset_all()
    got = run_burst(monkeypatch, "default", burst(seed))
    assert metrics.SCHED_BATCH_SIZE.total >= 40 > metrics.SCHED_BATCH_CLASSES.total
    assert metrics.FIT_VECTOR_PASS_MS.n >= 1
    want = run_burst(monkeypatch, "scalar", burst(seed))
    assert got == want
    assert any(p[0] for p, _ in got.values())
    assert any(not p[0] for p, _ in got.values())   # losers, with reasons


@pytest.mark.parametrize("seed", [0, 1])
def test_gang_and_auto_topology_pods_take_the_serial_route(seed,
                                                           monkeypatch):
    gid = 300 + seed
    extra = [pod(f"g{i}", 8, gang_id=gid, gang_size=2) for i in range(2)] + \
        [pod(f"auto{i}", 4, auto=True) for i in range(3)]
    got = run_burst(monkeypatch, "default", extra[:2] + burst(seed)[:12] +
                    extra[2:])
    want = run_burst(monkeypatch, "scalar", extra[:2] + burst(seed)[:12] +
                     extra[2:])
    assert got == want
    assert got["g0"][0][0] and got["g1"][0][0]
    api, _, sched = cluster("port", fake.hgx_h100_inventory(),
                            monkeypatch=monkeypatch)
    try:
        assert batch.batch_class(sched.generic, pod("a", 2, auto=True)) \
            is None
        assert batch.batch_class(sched.generic, pod("a", 2)) is not None
    finally:
        sched.stop()


def test_losers_park_for_retry_and_the_cycle_is_observed(monkeypatch):
    metrics.reset_all()
    api, _, sched = cluster("port", fake.rig_inventory(0),
                            monkeypatch=monkeypatch)
    try:
        for i in range(5):
            api.create_pod(pod(f"p{i}", 1))
        sched.run_until_idle()
        bound = [i for i in range(5) if placement(api, f"p{i}")[0]]
        assert len(bound) == 1
        assert sched.queue.pending_count() == 4
        assert metrics.SCHED_BATCH_SIZE.total >= 5
        assert metrics.SCHED_BATCH_CLASSES.n >= 1
        assert metrics.SCHED_THROUGHPUT.value > 0
        # each loser's event names the node's reason, as the oracle's
        msgs = [e["message"] for i in range(5) if i not in bound
                for e in api.list_events(f"p{i}")]
        assert msgs and all(m.startswith("0/1 nodes are available: 1 ")
                            for m in msgs), msgs
    finally:
        sched.stop()


def test_class_pass_matches_the_serial_filter_and_selection(monkeypatch):
    rng = random.Random(3)
    api, _ = build_cluster(rng)
    sched = engine(api, monkeypatch, "default")
    try:
        probe = pod("probe", 2)
        key = batch.batch_class(sched.generic, probe)
        cp = batch.open_class_pass(sched.generic, key, probe)
        assert cp is not None and cp.chips == 2
        feasible, failures, snaps, meta = \
            sched.generic.find_nodes_that_fit(probe)
        assert (cp.feasible, cp.failures) == (feasible, failures)
        scored = sched.generic.prioritize_nodes(probe, dict(feasible),
                                                snaps, meta)
        sched.generic._last_node_index = 0
        want = sched.generic.select_host(scored)
        sched.generic._last_node_index = 0
        assert batch.pick_host(sched.generic, cp) == want
    finally:
        sched.stop()


def test_the_batch_class_is_a_strict_content_hash(monkeypatch):
    api, _, sched = cluster("port", fake.hgx_h100_inventory(),
                            monkeypatch=monkeypatch)
    try:
        key = batch.batch_class(sched.generic, pod("a", 1))
        owned = pod("d", 1)
        owned["metadata"]["ownerReferences"] = [{"uid": "u-1",
                                                 "kind": "ReplicaSet"}]
        assert key is not None
        assert batch.batch_class(sched.generic, pod("b", 1)) == key
        assert batch.batch_class(sched.generic, owned) == key
        assert batch.batch_class(sched.generic, pod("c", 2)) != key
        assert batch.batch_class(
            sched.generic, pod("m", 1, memory=fake.H100_MEMORY)) != key
    finally:
        sched.stop()


def test_the_capacity_ledger_counts_cards_exactly(monkeypatch):
    api, _, sched = cluster("port", fake.hgx_h100_inventory(),
                            monkeypatch=monkeypatch)
    try:
        snap = sched.cache.snapshot_node("host0")
        assert batch.free_chip_count(snap.node_ex) == 8
        led = batch.CapacityLedger()
        assert led.covers("host0", 99, {"cpu": 10 ** 9})   # unseeded
        led.seed("host0", snap)
        assert led.covers("host0", 8, {}) and not led.covers("host0", 9, {})
        led.charge("host0", 3, {})
        assert led.covers("host0", 5, {}) and not led.covers("host0", 6, {})
        free = snap.core_allocatable["cpu"] - \
            snap.requested_core.get("cpu", 0)
        led2 = batch.CapacityLedger()
        led2.seed("host0", snap)
        assert led2.covers("host0", 0, {"cpu": free})
        assert not led2.covers("host0", 0, {"cpu": free + 1})
        # the first award seeds from the post-award snapshot
        api.create_pod(pod("a", 3))
        sched.run_until_idle()
        after = sched.cache.snapshot_node("host0")
        led3 = batch.CapacityLedger()
        led3.note_award("host0", after, 3, {})
        assert led3.covers("host0", 5, {}) and not led3.covers("host0", 6, {})
        led3.note_award("host0", after, 2, {})
        assert led3.covers("host0", 3, {}) and not led3.covers("host0", 4, {})
        info = sched.generic._pod_info_provider(pod("x", 4)).inv_info
        assert batch.pod_chip_demand(info) == 4
    finally:
        sched.stop()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pop_many_keeps_the_order_of_repeated_pop(seed):
    rng = random.Random(seed)
    pods = [pod(f"q{i}", 1, priority=rng.choice([0, 1, 5, 9]))
            for i in range(40)]
    one, many = SchedulingQueue(), SchedulingQueue()
    for p in pods:
        one.push(p)
    many.push_many(pods)
    want = []
    while True:
        p = one.pop(timeout=0.0)
        if p is None:
            break
        want.append(p["metadata"]["name"])
    got = []
    for size in (7, 13, 40):
        got += [p["metadata"]["name"] for p in many.pop_many(size,
                                                             timeout=0.0)]
    assert got == want and len(got) == 40
    assert many.pop_many(8, timeout=0.0) == []


def test_the_jax_default_path_places_alike_but_searches_every_node(
        monkeypatch):
    """The JAX engine's default path with the port's plugin places a
    count-mode burst as the port does: its zero card counts only disable
    prunes that are exact. But every GPU node is a shape of its own there,
    so it pays one allocator search per node where the port pays one per
    pod class (ROADMAP Queue 3)."""
    pods = [pod(f"u{i}", (1, 2, 4, 1)[i % 4]) for i in range(12)]
    hosts = [lambda i=i: fake.hgx_h100_inventory(i) for i in range(6)]
    counts = {}
    got = {}
    for name in ("jax", "port"):
        calls = _count_searches(monkeypatch)
        api, _, sched = cluster(name, *(h() for h in hosts),
                                monkeypatch=monkeypatch, path="default")
        try:
            for p in pods:
                api.create_pod(p)
            sched.run_until_idle()
            got[name] = outcome(api, [p["metadata"]["name"] for p in pods])
            counts[name] = len(calls)
        finally:
            sched.stop()
        monkeypatch.undo()
    assert got["jax"] == got["port"]
    assert all(p[0] for p, _ in got["port"].values())
    # three classes (1, 2 and 4 cards): a cold search each, then one
    # refit per award; the JAX path searches all six hosts per class
    assert counts["port"] < counts["jax"]
    assert counts["jax"] >= 3 * 6


def _two_hosts(api, hosts):
    for name in hosts:
        hosts[name].backend.set_chip_health(
            hosts[name].inventory.gpus[7].uuid, "failed")
        hosts[name].advertiser.advertise_once()


@pytest.mark.parametrize("engine_name", ["jax", "port"])
def test_a_batch_losers_reasons_name_every_node(engine_name, monkeypatch):
    """A burst over two 7-card hosts: the losers' FitError on the JAX
    default path comes from the class pass's failure map, which keeps no
    reason for a host that awards filled since it opened (``0/2 nodes are
    available: 1 ...`` or none at all), so its events differ from its own
    scalar path's; the port runs the serial pass for a loser and names
    both hosts, as the oracle does."""
    pods = [pod(f"l{i}", 2) for i in range(10)]
    got = {}
    for path in ("default", "scalar"):
        api, _, sched = cluster(engine_name, fake.hgx_h100_inventory(0),
                                fake.hgx_h100_inventory(1), tweak=_two_hosts,
                                monkeypatch=monkeypatch, path=path)
        try:
            for p in pods:
                api.create_pod(p)
            sched.run_until_idle()
            got[path] = outcome(api, [p["metadata"]["name"] for p in pods])
        finally:
            sched.stop()
    assert [p for p, _ in got["default"].values()] == \
        [p for p, _ in got["scalar"].values()]
    if engine_name == "jax":
        assert got["default"] != got["scalar"]
    else:
        assert got["default"] == got["scalar"]
        losers = [e for n, (p, ev) in got["default"].items() if not p[0]
                  for e in ev]
        assert losers and all(m.startswith("0/2 nodes are available: 2 ")
                              for _, m in losers), losers


@pytest.mark.parametrize("engine_name", ["jax", "port"])
def test_an_auto_topology_pod_on_the_default_path(engine_name, monkeypatch):
    """4-card auto-topology pods a, b, c over a PCIe and an HGX host, one
    at a time, on each engine's default path: the JAX masked pass treats
    the GPU auto-topology pod as broadcastable and serves ``c`` the PCIe
    host's shape verdict cached while the HGX board had room, so ``c``
    stays pending; the port routes such pods to the scalar chain and
    binds ``c`` to the PCIe host."""
    api, _, sched = cluster(engine_name, fake.pcie_h100_inventory(),
                            fake.hgx_h100_inventory(host=1),
                            monkeypatch=monkeypatch, path="default")
    try:
        for name in "abc":
            api.create_pod(pod(name, 4, auto=True))
            sched.run_until_idle()
        nodes = [placement(api, n)[0] for n in "abc"]
    finally:
        sched.stop()
    assert nodes[:2] == ["host1", "host1"]
    assert nodes[2] == (None if engine_name == "jax" else "host0")


def test_a_burst_on_a_fresh_fleet_binds_in_one_cycle(monkeypatch):
    """The mass-arrival shape at CPU size: 40 pods of 1, 2, 4, 1 cards
    over 16 HGX hosts, every pod bound in one cycle, card for card as the
    oracle, with fewer allocator searches than the oracle pays."""
    pods = [pod(f"m{i}", (1, 2, 4, 1)[i % 4]) for i in range(40)]
    got, searches = {}, {}
    for path in ("default", "scalar"):
        calls = _count_searches(monkeypatch)
        api = InMemoryAPIServer()
        for i in range(16):
            GPUHost(api, f"host{i:02d}", fake.hgx_h100_inventory(i))
        sched = engine(api, monkeypatch, "default" if path == "default"
                       else "oracle")
        try:
            for p in pods:
                api.create_pod(p)
            metrics.reset_all()
            sched.run_until_idle()
            got[path] = outcome(api, [p["metadata"]["name"] for p in pods])
            searches[path] = len(calls)
            if path == "default":
                assert metrics.SCHED_BATCH_SIZE.n == 1
                assert metrics.SCHED_BATCH_SIZE.total == 40
        finally:
            sched.stop()
        monkeypatch.undo()
    assert got["default"] == got["scalar"]
    assert all(p[0] for p, _ in got["default"].values())
    assert searches["default"] < searches["scalar"]
