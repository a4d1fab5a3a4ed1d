"""The port's node lifecycle controller
(`kubegpu_tpu_torch/scheduler/lifecycle.py`) held against the JAX one
(`kubegpu_tpu/scheduler/lifecycle.py`), as tests/test_node_lifecycle.py
holds the JAX one alone.

Each test builds the same seeded GPU fleet twice on the JAX in-memory API
server (fake HGX and PCIe hosts whose advertisers stamp heartbeats from an
injected clock, pods placed by the port's engine), runs the JAX
``NodeLifecycle`` over one and the port's over the other (through
`PortAPI`, which re-raises the server's errors as the port's), ticks both
on the same clock, and compares every tick's states and evictions, the
pods left in the API (a requeued copy decoded by the codec), the nodes,
the events and the lifecycle metrics.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

from kubegpu_tpu import metrics as jax_metrics  # noqa: E402
from kubegpu_tpu.core import codec as jax_codec  # noqa: E402
from kubegpu_tpu.scheduler import lifecycle as jax_lifecycle  # noqa: E402
from kubegpu_tpu_torch import metrics  # noqa: E402
from kubegpu_tpu_torch.core import codec  # noqa: E402
from kubegpu_tpu_torch.node import fake  # noqa: E402
from kubegpu_tpu_torch.scheduler import lifecycle  # noqa: E402
from kubegpu_tpu_torch.scheduler.core import Scheduler  # noqa: E402
from kubegpu_tpu_torch.scheduler.gang import (  # noqa: E402
    GANG_PROCESS_ANNOTATION)
from kubegpu_tpu_torch.scheduler.registry import (  # noqa: E402
    build_device_scheduler)
from tests.torch_sched import PortAPI, cluster, placement, pod  # noqa: E402

INVENTORIES = (lambda: fake.hgx_h100_inventory(0),
               lambda: fake.pcie_h100_inventory(1),
               lambda: fake.hgx_h100_inventory(2),
               lambda: fake.pcie_h100_inventory(3))


class Fleet:
    """One copy of the seeded fleet: hosts advertising from ``clock``,
    the pods of ``seed`` placed by the port's engine (a gang of two 8-card
    members spread over two hosts among them), and one node registered
    without a heartbeat."""

    def __init__(self, seed: int, clock: dict):
        self.clock = clock
        self.api, self.hosts, self.sched = cluster(
            "port", *(inv() for inv in INVENTORIES))
        for host in self.hosts.values():
            host.advertiser.clock = lambda: clock["now"]
            host.advertiser.advertise_once()
        self.api.create_node({"metadata": {"name": "legacy"},
                              "status": {"allocatable": {"cpu": "8",
                                                         "pods": 10}}})
        self.names = [f"g{i}" for i in range(2)]
        for name in self.names:
            self.api.create_pod(pod(name, 8, gang_id=40 + seed,
                                    gang_size=2))
        self.sched.run_until_idle()
        rng = np.random.default_rng(seed)
        for i in range(8):
            self.names.append(f"p{i}")
            self.api.create_pod(pod(f"p{i}", int(rng.choice((1, 2, 4)))))
        self.sched.run_until_idle()
        self.sched.stop()

    def beat(self, alive) -> None:
        for name in sorted(alive):
            self.hosts[name].advertiser.advertise_once()

    def state(self) -> dict:
        """Pods (their device annotation decoded), nodes and events."""
        pods = {}
        for p in self.api.list_pods():
            info = jax_codec.kube_pod_to_pod_info(p, False).to_json()
            ann = dict(p["metadata"].get("annotations") or {})
            ann.pop(codec.POD_ANNOTATION_KEY, None)
            pods[p["metadata"]["name"]] = (p["spec"].get("nodeName"), info,
                                           ann)
        nodes = sorted(n["metadata"]["name"] for n in self.api.list_nodes())
        events = sorted((e["involvedObject"]["kind"],
                         e["involvedObject"]["name"], e["type"],
                         e["reason"], e["message"], e["count"])
                        for e in self.api.list_events())
        return {"pods": pods, "nodes": nodes, "events": events}


def _pair(seed: int, wrap=lambda api: api, **kw):
    """``(clock, jax fleet, jax controller, port fleet, port controller)``
    on one clock."""
    clock = {"now": 1000.0}
    jf, pf = Fleet(seed, clock), Fleet(seed, clock)
    assert jf.state() == pf.state()
    jc = jax_lifecycle.NodeLifecycle(wrap(jf.api), clock=lambda: clock["now"],
                                     **kw)
    pc = lifecycle.NodeLifecycle(wrap(PortAPI(pf.api)),
                                 clock=lambda: clock["now"], **kw)
    return clock, jf, jc, pf, pc


def _tick_both(jc, pc):
    want, got = jc.tick(), pc.tick()
    assert got == want
    return got


def _metrics():
    return (metrics.NODE_LOST.value, metrics.EVICTIONS.value,
            metrics.NODE_READY.value)


def _jax_metrics():
    return (jax_metrics.NODE_LOST.value, jax_metrics.EVICTIONS.value,
            jax_metrics.NODE_READY.value)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_a_lost_node_evicts_and_requeues_as_the_jax_controller_does(seed):
    """The host of gang member ``g0`` stops stamping: both controllers
    see it Ready, Stale, then Lost, delete it, evict its pods and the
    whole gang (the member on a surviving host too), requeue copies
    without cards or contract, and record the same events. The node
    without a heartbeat stays Ready throughout."""
    metrics.reset_all()
    jax_metrics.reset_all()
    clock, jf, jc, pf, pc = _pair(seed, stale_after_s=30.0,
                                  lost_after_s=90.0)
    before = {n: placement(pf.api, n)[0] for n in pf.names}
    victim, other = before["g0"], before["g1"]
    assert victim and other and victim != other
    alive = set(pf.hosts) - {victim}
    seen = []
    for now in (1000.0, 1040.0, 1095.0, 1100.0):
        clock["now"] = now
        for f in (jf, pf):
            f.beat(alive)
        out = _tick_both(jc, pc)
        seen.append(out["states"][victim] if victim in out["states"]
                    else None)
        assert out["states"]["legacy"] == lifecycle.READY
        assert _metrics() == _jax_metrics()
    assert seen == [lifecycle.READY, lifecycle.STALE, lifecycle.LOST, None]
    assert metrics.NODE_LOST.value == 1
    state = pf.state()
    assert state == jf.state()
    assert victim not in state["nodes"] and "legacy" in state["nodes"]
    evicted = {n for n, (node, _, _) in state["pods"].items()
               if not node and before[n]}
    on_victim = {n for n, node in before.items() if node == victim}
    assert evicted == on_victim | {"g1"}
    assert metrics.EVICTIONS.value == len(evicted)
    for name in evicted:
        _, info, ann = state["pods"][name]
        assert GANG_PROCESS_ANNOTATION not in ann
        assert "nodename" not in info
        for cont in info["runningcontainer"].values():
            assert not cont.get("allocatefrom")
    assert ("Node", victim, "Warning", "NodeLost") in \
        {e[:4] for e in state["events"]}
    # a fresh engine places the requeued pods on live hosts only
    sched = Scheduler(PortAPI(pf.api), build_device_scheduler())
    try:
        sched.run_until_idle()
    finally:
        sched.stop()
    assert victim not in {placement(pf.api, n)[0] for n in pf.names}


@pytest.mark.parametrize("seed", [0, 1])
def test_clock_skew_and_nodes_without_a_heartbeat(seed):
    """Liveness ages the controller's observation of a changing stamp, so
    a node whose clock runs 300 s behind stays Ready while it stamps; a
    node registered without a heartbeat is never aged."""
    clock, jf, jc, pf, pc = _pair(seed, stale_after_s=30.0,
                                  lost_after_s=90.0)
    for f in (jf, pf):
        for host in f.hosts.values():
            host.advertiser.clock = lambda: clock["now"] - 300.0
    for _ in range(5):
        for f in (jf, pf):
            f.beat(f.hosts)
        out = _tick_both(jc, pc)
        assert set(out["states"].values()) == {lifecycle.READY}
        clock["now"] += 20.0
    clock["now"] += 95.0
    out = _tick_both(jc, pc)
    assert out["states"] == {**{n: lifecycle.LOST for n in pf.hosts},
                             "legacy": lifecycle.READY}
    assert pf.state() == jf.state()


def test_the_orphan_sweep_reclaims_a_pod_bound_to_a_missing_node():
    clock, jf, jc, pf, pc = _pair(0, stale_after_s=2.0, lost_after_s=5.0)
    for f in (jf, pf):
        f.api.create_pod(pod("stray", 1))
        f.api.bind_pod("stray", "ghost-node")
    out = _tick_both(jc, pc)
    assert out["evicted"] == ["stray"]
    assert pf.state() == jf.state()
    assert not pf.api.get_pod("stray")["spec"].get("nodeName")


class _Flaky:
    """The API, with the first ``n`` calls of ``verb`` for ``target``
    failing as a dropped connection."""

    def __init__(self, api, verb, target, n):
        self._api, self._verb, self._target, self._left = \
            api, verb, target, n

    def __getattr__(self, name):
        real = getattr(self._api, name)
        if name != self._verb:
            return real

        def call(arg, *a, **kw):
            key = arg if isinstance(arg, str) else arg["metadata"]["name"]
            if key == self._target and self._left > 0:
                self._left -= 1
                raise ConnectionError("injected transport failure")
            return real(arg, *a, **kw)
        return call


@pytest.mark.parametrize("verb", ["delete_pod", "create_pod"])
def test_transient_write_failures_are_retried_as_the_jax_controller_does(
        verb):
    """The surviving gang member's delete (or its replacement's create)
    fails through the whole Lost tick: both controllers park it and land
    it by name on the next tick."""
    clock = {"now": 1000.0}
    jf, pf = Fleet(0, clock), Fleet(0, clock)
    victim = placement(pf.api, "g0")[0]
    jc = jax_lifecycle.NodeLifecycle(_Flaky(jf.api, verb, "g1", 6),
                                     stale_after_s=2.0, lost_after_s=5.0,
                                     clock=lambda: clock["now"])
    pc = lifecycle.NodeLifecycle(_Flaky(PortAPI(pf.api), verb, "g1", 6),
                                 stale_after_s=2.0, lost_after_s=5.0,
                                 clock=lambda: clock["now"])
    _tick_both(jc, pc)
    clock["now"] = 1010.0
    for f in (jf, pf):
        f.beat(set(f.hosts) - {victim})
    out = _tick_both(jc, pc)
    assert "g0" in out["evicted"] and "g1" not in out["evicted"]
    assert pf.state() == jf.state()
    out = _tick_both(jc, pc)
    assert out["evicted"] == ["g1"]
    assert pf.state() == jf.state()
    assert not pf.api.get_pod("g1")["spec"].get("nodeName")
    assert pc.evicted_total == jc.evicted_total


def test_an_externally_deleted_pod_is_not_resurrected():
    clock, jf, jc, pf, pc = _pair(1, stale_after_s=2.0, lost_after_s=5.0)
    victim = placement(pf.api, "p0")[0]
    _tick_both(jc, pc)
    clock["now"] = 1010.0
    for f in (jf, pf):
        f.beat(set(f.hosts) - {victim})
        real = f.api.list_pods

        def listing(node_name=None, real=real, api=f.api, **kw):
            out = real(node_name=node_name, **kw)
            if node_name and any(p["metadata"]["name"] == "p0"
                                 for p in out):
                api.delete_pod("p0")      # the user tears it down
            return out
        f.api.list_pods = listing
    out = _tick_both(jc, pc)
    assert "p0" not in out["evicted"]
    for f in (jf, pf):
        with pytest.raises(KeyError):
            f.api.get_pod("p0")
    assert _tick_both(jc, pc)["evicted"] == []


def test_requeued_copy_equals_the_jax_one():
    """A bound GPU gang member: binding, status, contract, nomination,
    checkpoint request and cards stripped; ``alpha.gpu/*`` and the gang
    keys kept."""
    _, pf = None, Fleet(0, {"now": 1000.0})
    bound = pf.api.get_pod("g0")
    assert bound["spec"]["nodeName"]
    bound["status"] = {"phase": "Running"}
    ann = bound["metadata"]["annotations"]
    assert GANG_PROCESS_ANNOTATION in ann
    ann[Scheduler.NOMINATED_NODE_ANNOTATION] = "host0"
    ann[lifecycle.CHECKPOINT_REQUEST_ANNOTATION] = "{}"
    got, want = lifecycle.requeued_copy(bound), \
        jax_lifecycle.requeued_copy(bound)
    assert got == want
    assert "nodeName" not in got["spec"] and "status" not in got
    kept = got["metadata"]["annotations"]
    for key in (GANG_PROCESS_ANNOTATION, Scheduler.NOMINATED_NODE_ANNOTATION,
                lifecycle.CHECKPOINT_REQUEST_ANNOTATION):
        assert key not in kept
    info = codec.kube_pod_to_pod_info(got, invalidate_existing=False)
    assert not info.node_name
    assert info.requests["alpha.tpu/gang-size"] == 2
    cont = info.running_containers["main"]
    assert cont.requests["alpha.gpu/numgpu"] == 8
    assert not cont.allocate_from
