"""The tenant quota gate of the port (kubegpu_tpu_torch/scheduler/quota.py,
with the pod-side helpers of kubegpu_tpu_torch/cluster/apf.py), counting
GPU cards.

The port's `DRFQuotaGate` and the JAX package's run side by side on the
same seeded tenant streams (nodes joining, pods pending, admitted, parked,
bound and gone, weights set one by one or all at once, resyncs and release
nudges): the JAX gate gets a TPU twin of each GPU pod and node with the
same count, and both reach the same decisions — each admit's outcome, the
pods each release requeues, the parked count and every tenant's shares.
The JAX gate counts 0 cards in a GPU pod and on a GPU node, so over a GPU
fleet it shares CPU alone. Through the port's engine on fake HGX hosts: a
flood is held to its tenant's fair share and re-admitted on release, a
gang is gated whole, a failed cycle leaves no in-flight charge, and the
API server's quota weights reach the gate."""

import random
import time

import pytest

pytest.importorskip("torch")

from kubegpu_tpu.cluster import apf as jax_apf  # noqa: E402
from kubegpu_tpu.cluster.apiserver import QuotaExceeded as JaxQuotaExceeded  # noqa: E402
from kubegpu_tpu.core import codec as jax_codec  # noqa: E402
from kubegpu_tpu.core.types import ContainerInfo, NodeInfo, PodInfo  # noqa: E402
from kubegpu_tpu.scheduler import quota as jax_quota  # noqa: E402
from kubegpu_tpu_torch import metrics, obs  # noqa: E402
from kubegpu_tpu_torch.cluster import apf  # noqa: E402
from kubegpu_tpu_torch.cluster.httpapi import QuotaExceeded  # noqa: E402
from kubegpu_tpu_torch.core import grammar  # noqa: E402
from kubegpu_tpu_torch.node import fake  # noqa: E402
from kubegpu_tpu_torch.scheduler import quota  # noqa: E402
from tests.torch_sched import cluster, placement, pod  # noqa: E402

TENANT = apf.TENANT_LABEL


def gpu_pod(name, tenant, cards=1, gang=None, gang_size=0, cpu="1"):
    p = pod(name, cards, gang_id=gang, gang_size=gang_size or None)
    if tenant:
        p["metadata"]["labels"] = {TENANT: tenant}
    p["spec"]["containers"][0]["resources"]["requests"]["cpu"] = cpu
    return p


def tpu_twin(gpu):
    """The same pod asking for as many TPU chips as ``gpu`` asks cards."""
    pi = jax_codec.kube_pod_to_pod_info(gpu, invalidate_existing=False)
    twin = PodInfo(name=gpu["metadata"]["name"], requests=dict(pi.requests))
    for name, cont in pi.running_containers.items():
        twin.running_containers[name] = ContainerInfo(requests={
            "alpha.tpu/numchips": cont.requests.get(grammar.RESOURCE_NUM_GPU,
                                                    0)})
    meta = {k: v for k, v in gpu["metadata"].items() if k != "annotations"}
    jax_codec.pod_info_to_annotation(meta, twin)
    out = {"metadata": meta, "spec": dict(gpu["spec"])}
    return out


def gpu_node(name, cards=8, cpu=64, host=0):
    info = NodeInfo()
    for i in range(cards):
        info.allocatable[grammar.gpu_resource(
            fake.fake_uuid(host, i), grammar.CARDS_SUFFIX,
            (grammar.GPU_GRP1, 0), (grammar.GPU_GRP0, i // 2))] = 1
        info.allocatable[grammar.gpu_resource(
            fake.fake_uuid(host, i), grammar.MEMORY_SUFFIX,
            (grammar.GPU_GRP1, 0), (grammar.GPU_GRP0, i // 2))] = \
            fake.H100_MEMORY
    meta = {"name": name}
    jax_codec.node_info_to_annotation(meta, info)
    return {"metadata": meta,
            "status": {"allocatable": {"cpu": str(cpu), "pods": 100}}}


def tpu_node(name, chips=8, cpu=64):
    info = NodeInfo()
    for i in range(chips):
        info.allocatable[
            f"alpha/grpresource/tpugrp1/0/tpugrp0/0/tpu/{i}.0.0/chips"] = 1
    meta = {"name": name}
    jax_codec.node_info_to_annotation(meta, info)
    return {"metadata": meta,
            "status": {"allocatable": {"cpu": str(cpu), "pods": 100}}}


# ---- the helpers ------------------------------------------------------------


def test_the_port_counts_cards_where_jax_counts_chips():
    p = gpu_pod("p", "t", cards=3)
    assert quota.pod_resource_demand(p) == {"chips": 3.0, "cpu": 1.0}
    assert jax_quota.pod_resource_demand(tpu_twin(p)) == \
        {"chips": 3.0, "cpu": 1.0}
    assert quota.node_resource_totals(gpu_node("n", cards=8)) == \
        {"chips": 8.0, "cpu": 64.0}
    assert jax_quota.node_resource_totals(tpu_node("n", chips=8)) == \
        {"chips": 8.0, "cpu": 64.0}


def test_jax_counts_no_card_in_a_gpu_pod_or_on_a_gpu_node():
    """[jax] The JAX helpers read ``alpha.tpu/numchips`` and ``/chips``
    leaves only: a GPU pod demands 0 cards and a GPU node adds 0 to
    capacity (ROADMAP Queue 3)."""
    p = gpu_pod("p", "t", cards=4)
    assert jax_apf.pod_chip_request(p) == 0
    assert jax_quota.node_resource_totals(gpu_node("n"))["chips"] == 0.0
    assert apf.pod_chip_request(p) == 4


def test_a_card_leaf_request_counts_where_numgpu_is_absent():
    pi = PodInfo(name="pinned")
    leaf = grammar.gpu_resource(fake.fake_uuid(0, 1), grammar.CARDS_SUFFIX)
    pi.running_containers["main"] = ContainerInfo(requests={leaf: 1})
    pi.running_containers["side"] = ContainerInfo(
        requests={grammar.RESOURCE_NUM_GPU: 2})
    meta = {"name": "pinned"}
    jax_codec.pod_info_to_annotation(meta, pi)
    assert apf.pod_chip_request({"metadata": meta, "spec": {}}) == 3


@pytest.mark.parametrize("meta", [
    {"labels": {TENANT: "acme"}},
    {"labels": {"tenant": "beta"}},
    {"annotations": {apf.TENANT_ANNOTATION: "gamma"}},
    {"labels": {TENANT: "acme"}, "annotations": {apf.TENANT_ANNOTATION: "x"}},
    {}])
def test_tenant_identity_equals_jax(meta):
    p = {"metadata": dict(meta, name="p"), "spec": {}}
    assert apf.tenant_of_pod(p) == jax_apf.tenant_of_pod(p)
    assert apf.pod_cpu_request(gpu_pod("c", "t", cpu="1500m")) == \
        jax_apf.pod_cpu_request(gpu_pod("c", "t", cpu="1500m")) == 2.0


# ---- the gates on one stream ------------------------------------------------


class Twins:
    """The port's gate over GPU objects and the JAX gate over their TPU
    twins, driven alike; every call returns both results."""

    def __init__(self, weights=None, grace=5.0):
        self.pushed = ([], [])
        self.gates = (quota.DRFQuotaGate(weights=weights,
                                         hungry_grace_s=grace),
                      jax_quota.DRFQuotaGate(weights=weights,
                                             hungry_grace_s=grace))
        for gate, out in zip(self.gates, self.pushed):
            gate.requeue = lambda p, out=out: out.append(
                p["metadata"]["name"])

    def node(self, method, gpu_obj, tpu_obj):
        getattr(self.gates[0], method)(gpu_obj)
        getattr(self.gates[1], method)(tpu_obj)

    def pod(self, method, gpu, *members):
        getattr(self.gates[0], method)(gpu, *members)
        getattr(self.gates[1], method)(
            tpu_twin(gpu), *([tpu_twin(m) for m in ms] for ms in members))

    def admit(self, pods):
        out = []
        for gate, exc, batch in ((self.gates[0], QuotaExceeded, pods),
                                 (self.gates[1], JaxQuotaExceeded,
                                  [tpu_twin(p) for p in pods])):
            try:
                gate.admit(batch)
                out.append("admitted")
            except exc:
                out.append("refused")
        return out

    def state(self):
        return [(g.parked_count(), g.shares()) for g in self.gates]


def _stream(seed, twins, n_ops=120):
    """A seeded stream of gate calls; asserts equal decisions throughout."""
    rng = random.Random(seed)
    tenants = ["a", "b", "c"]
    pending, bound, parked = {}, {}, {}
    nodes = []
    serial = 0

    def new_pod():
        nonlocal serial
        serial += 1
        tenant = rng.choice(tenants + [None])
        if rng.random() < 0.2:
            size = rng.randint(2, 3)
            return [gpu_pod(f"s{seed}-{serial}-{i}", tenant,
                            cards=rng.choice([1, 2]), gang=serial,
                            gang_size=size) for i in range(size)]
        return [gpu_pod(f"s{seed}-{serial}", tenant,
                        cards=rng.choice([1, 1, 2, 4]),
                        cpu=rng.choice(["1", "2", "500m"]))]

    for _ in range(n_ops):
        op = rng.random()
        if op < 0.08 or not nodes:
            name = f"n{len(nodes)}"
            cards, cpu = rng.choice([(8, 64), (4, 32), (1, 16)])
            nodes.append(name)
            twins.node("set_node", gpu_node(name, cards, cpu),
                       tpu_node(name, cards, cpu))
        elif op < 0.35:
            pods = new_pod()
            for p in pods:
                twins.pod("pod_pending", p)
            pending[pods[0]["metadata"]["name"]] = pods
        elif op < 0.6 and pending:
            key = rng.choice(sorted(pending))
            pods = pending.pop(key)
            got = twins.admit(pods)
            assert got[0] == got[1], (key, got)
            if got[0] == "admitted":
                for p in pods:
                    p["spec"]["nodeName"] = rng.choice(nodes)
                    twins.pod("pod_bound", p)
                bound[key] = pods
            else:
                twins.pod("park", pods[0], pods)
                parked[key] = pods
        elif op < 0.72 and bound:
            key = rng.choice(sorted(bound))
            for p in bound.pop(key):
                twins.pod("pod_gone", p)
        elif op < 0.8:
            tenant = rng.choice(tenants)
            w = rng.choice([0.5, 1.0, 2.0, 3.0])
            for gate in twins.gates:
                gate.set_weight(tenant, w)
        elif op < 0.84:
            weights = {t: rng.choice([1.0, 2.0]) for t in tenants
                       if rng.random() < 0.6}
            for gate in twins.gates:
                gate.set_weights(weights)
        elif op < 0.88 and parked:
            key = rng.choice(sorted(parked))
            for gate in twins.gates:
                gate.forget(parked[key][0]["metadata"]["name"])
        elif op < 0.92:
            live = [p for pods in list(pending.values()) + list(
                bound.values()) + list(parked.values()) for p in pods]
            gpu_nodes = [gpu_node(n, 8, 64) for n in nodes]
            tpu_nodes = [tpu_node(n, 8, 64) for n in nodes]
            twins.gates[0].resync(gpu_nodes, live)
            twins.gates[1].resync(tpu_nodes, [tpu_twin(p) for p in live])
        else:
            got = [gate.release_due() for gate in twins.gates]
            assert got[0] == got[1]
        assert twins.pushed[0] == twins.pushed[1]
        a, b = twins.state()
        assert a == b, (a, b)
    return twins


@pytest.mark.parametrize("seed", range(12))
def test_the_gates_decide_alike_on_a_seeded_stream(seed):
    twins = _stream(seed, Twins(grace=5.0 if seed % 2 else 0.0))
    assert twins.pushed[0] == twins.pushed[1]


def test_the_streams_admit_refuse_park_and_release():
    """The seeded streams are not trivial: across them both gates admit,
    refuse, park and requeue."""
    admitted = refused = 0
    requeued = 0
    for seed in range(12):
        twins = Twins(grace=5.0 if seed % 2 else 0.0)
        real = twins.admit

        def count(pods, real=real):
            nonlocal admitted, refused
            got = real(pods)
            admitted += got[0] == "admitted"
            refused += got[0] == "refused"
            return got
        twins.admit = count
        _stream(seed, twins)
        requeued += len(twins.pushed[0])
    assert admitted > 100 and refused > 10 and requeued > 5, \
        (admitted, refused, requeued)


@pytest.mark.parametrize("weights,admits", [({"A": 2.0, "B": 1.0}, 8),
                                            (None, 6)])
def test_weighted_fair_shares_equal_jax(weights, admits):
    twins = Twins(weights=weights)
    twins.node("set_node", gpu_node("n0", 8), tpu_node("n0", 8))
    twins.node("set_node", gpu_node("n1", 4, host=1), tpu_node("n1", 4))
    twins.pod("pod_pending", gpu_pod("b-0", "B"))
    outcomes = [twins.admit([gpu_pod(f"a-{i}", "A")]) for i in range(10)]
    assert all(a == b for a, b in outcomes)
    assert [a for a, _ in outcomes].count("admitted") == admits


def test_a_gang_is_admitted_or_parked_whole_alike():
    twins = Twins()
    twins.node("set_node", gpu_node("n0", 16), tpu_node("n0", 16))
    twins.pod("pod_pending", gpu_pod("b-0", "B"))
    ok = [gpu_pod(f"g-{i}", "A", cards=2, gang=7, gang_size=4)
          for i in range(4)]
    over = [gpu_pod(f"h-{i}", "A", cards=2, gang=8, gang_size=4)
            for i in range(4)]
    assert twins.admit(ok) == ["admitted", "admitted"]
    assert twins.admit(over) == ["refused", "refused"]
    twins.pod("park", over[0], over)
    assert twins.admit([gpu_pod("a-x", "A")]) == ["refused", "refused"]
    assert twins.admit([gpu_pod("b-0", "B")]) == ["admitted", "admitted"]
    assert twins.state()[0] == twins.state()[1]
    assert twins.state()[0][0] == 1


def test_quota_parked_total_counts_a_park():
    gate = quota.DRFQuotaGate()
    gate.set_node(gpu_node("n0", 2))
    gate.pod_pending(gpu_pod("b", "B"))
    gate.admit([gpu_pod("a-0", "A")])
    over = gpu_pod("a-1", "A")
    before = metrics.QUOTA_PARKED.value
    with pytest.raises(QuotaExceeded, match="card"):
        gate.admit([over])
    gate.park(over)
    assert metrics.QUOTA_PARKED.value == before + 1


# ---- through the port's engine ----------------------------------------------


def _bound(api):
    return {p["metadata"]["name"] for p in api.list_pods()
            if (p.get("spec") or {}).get("nodeName")}


def _engine(gate, monkeypatch, n=1):
    return cluster("port", *[fake.hgx_h100_inventory(host=i)
                             for i in range(n)],
                   monkeypatch=monkeypatch, quota=gate)


def test_the_engine_holds_a_flood_to_its_share_and_readmits(monkeypatch):
    """8 cards: tenant A floods 8 pods, B asks for 4. A is held to 4 while
    B demands; B's pods gone, A's overflow re-admits and fills the host."""
    gate = quota.DRFQuotaGate(hungry_grace_s=0.2)
    api, _, sched = _engine(gate, monkeypatch)
    parked_before = metrics.QUOTA_PARKED.value
    try:
        for i in range(8):
            api.create_pod(gpu_pod(f"a-{i}", "A"))
        for i in range(4):
            api.create_pod(gpu_pod(f"b-{i}", "B"))
        sched.run_until_idle()
        got = _bound(api)
        assert len({n for n in got if n.startswith("b-")}) == 4
        assert len({n for n in got if n.startswith("a-")}) == 4
        assert metrics.QUOTA_PARKED.value > parked_before
        for name in sorted(n for n in got if n.startswith("b-")):
            api.delete_pod(name)
        time.sleep(0.25)
        sched.run_until_idle()
        assert len(_bound(api)) == 8
        assert gate.parked_count() == 0
    finally:
        sched.stop()


def test_a_gang_over_its_share_binds_no_member(monkeypatch):
    gate = quota.DRFQuotaGate()
    api, _, sched = _engine(gate, monkeypatch)
    try:
        api.create_pod(gpu_pod("gb-0", "B"))
        for i in range(4):
            api.create_pod(gpu_pod(f"ga-{i}", "A", cards=2, gang=9,
                                   gang_size=4))
        sched.run_until_idle()
        got = _bound(api)
        assert not any(n.startswith("ga-") for n in got), got
        assert "gb-0" in got
    finally:
        sched.stop()


def test_a_failed_cycle_leaves_no_inflight_charge(monkeypatch):
    gate = quota.DRFQuotaGate()
    api, _, sched = _engine(gate, monkeypatch)
    try:
        api.create_pod(gpu_pod("fb-0", "B"))
        api.create_pod(gpu_pod("fa-big", "A", cards=16))  # fits nowhere
        api.create_pod(gpu_pod("fa-small", "A"))
        sched.run_until_idle()
        got = _bound(api)
        assert {"fa-small", "fb-0"} <= got, got
    finally:
        sched.stop()


def test_quota_weights_reach_the_gate_through_the_watch(monkeypatch):
    gate = quota.DRFQuotaGate()
    api, _, sched = _engine(gate, monkeypatch)
    try:
        api.set_quota("heavy", {"weight": 3.0})
        api.create_pod(gpu_pod("light-0", "light"))
        for i in range(8):
            api.create_pod(gpu_pod(f"heavy-{i}", "heavy"))
        sched.run_until_idle()
        got = _bound(api)
        assert len([n for n in got if n.startswith("heavy-")]) == 6, got
        assert "light-0" in got
        api.delete_quota("heavy")
        assert gate.shares()["heavy"]["fair_fraction"] == pytest.approx(0.5)
    finally:
        sched.stop()


def test_a_parked_pod_explains_quota_exceeded(monkeypatch):
    gate = quota.DRFQuotaGate()
    api, _, sched = _engine(gate, monkeypatch)
    try:
        for i in range(8):
            api.create_pod(gpu_pod(f"qa-{i}", "QA"))
        api.create_pod(gpu_pod("qb-0", "QB"))
        sched.run_until_idle()
        parked = [f"qa-{i}" for i in range(8)
                  if placement(api, f"qa-{i}")[0] is None]
        assert parked
        assert any("QuotaExceeded" in str(obs.explain_pod(n).get(
            "last_failure", "")) for n in parked)
    finally:
        sched.stop()


@pytest.mark.parametrize("engine", ["jax", "port"])
def test_configured_weights_survive_the_cold_start_sync(engine, monkeypatch):
    """[jax] The engine replaces the gate's weights with the API server's
    quota objects at cold start, so the JAX engine drops the configured
    ``tenantWeights`` (a:3) for 1.0 (ROADMAP Queue 3). The port keeps a
    configured weight under the server's: a quota object's weight wins,
    and its deletion returns the tenant to its configured weight."""
    gate = (quota if engine == "port" else jax_quota).DRFQuotaGate(
        weights={"a": 3.0})
    api, _, sched = cluster(engine, fake.hgx_h100_inventory(),
                            monkeypatch=monkeypatch, quota=gate)
    try:
        api.create_pod(gpu_pod("a0", "a"))
        api.create_pod(gpu_pod("b0", "b"))
        configured = 0.75 if engine == "port" else 0.5

        def fair():
            return gate.shares()["a"]["fair_fraction"]
        assert fair() == pytest.approx(configured)
        api.set_quota("a", {"weight": 1.0})
        assert fair() == pytest.approx(0.5)
        api.delete_quota("a")
        assert fair() == pytest.approx(configured)
    finally:
        sched.stop()
